"""Training: host dedup, losses and the train step (``Trainer``)."""
from .dedup import dedup_bucket, dedup_capable, pad_dedup_to, prep_dedup_batch
from .losses import binary_logloss, categorical_crossentropy, l2_penalty, loss_fn_for
from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "dedup_bucket", "dedup_capable", "pad_dedup_to",
           "prep_dedup_batch", "binary_logloss", "categorical_crossentropy", "l2_penalty",
           "loss_fn_for"]
