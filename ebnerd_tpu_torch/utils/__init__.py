"""Submission files, logging and timing, and general helpers (copies and
counterparts of ``ebnerd_tpu.utils``)."""
from .logging import ScalarLogger, StepTimer, trace_profile
from .submission import (
    rank_predictions_by_score,
    rank_ragged_scores,
    read_submission_file,
    write_submission_file,
    zip_submission_file,
)

__all__ = ["ScalarLogger", "StepTimer", "trace_profile", "rank_predictions_by_score",
           "rank_ragged_scores", "read_submission_file", "write_submission_file",
           "zip_submission_file"]
