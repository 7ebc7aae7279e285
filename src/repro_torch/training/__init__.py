from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update, cosine_schedule, clip_by_global_norm
from repro_torch.training.train_step import TrainState, make_train_step, train_state_init
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import SyntheticTokenPipeline

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "clip_by_global_norm",
    "TrainState",
    "make_train_step",
    "train_state_init",
    "CheckpointManager",
    "SyntheticTokenPipeline",
]
