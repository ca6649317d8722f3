"""Training library (reference L3): the plateau-driven trainer replacing
dlib's dnn_trainer semantics behind NetPimpl::TrainingNet."""

from annonet_jax.train.plateau import (
    count_steps_without_decrease,
    count_steps_without_decrease_robust,
)
from annonet_jax.train.trainer import (
    Trainer,
    TrainerConfig,
    make_fused_train_step,
    make_train_step,
)

__all__ = [
    "Trainer",
    "TrainerConfig",
    "make_fused_train_step",
    "make_train_step",
    "count_steps_without_decrease",
    "count_steps_without_decrease_robust",
]
