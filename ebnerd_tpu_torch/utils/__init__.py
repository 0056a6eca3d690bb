"""Submission files and scalar logging (copies from ``ebnerd_tpu.utils``)."""
from .logging import ScalarLogger
from .submission import (
    rank_predictions_by_score,
    rank_ragged_scores,
    read_submission_file,
    write_submission_file,
    zip_submission_file,
)

__all__ = ["ScalarLogger", "rank_predictions_by_score", "rank_ragged_scores",
           "read_submission_file", "write_submission_file", "zip_submission_file"]
