"""Training: AdamW, the train step, checkpoints, compression, data."""
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.train_loop import make_train_step, TrainState
from repro_torch.training.checkpoint import save_checkpoint, load_checkpoint
from repro_torch.training.compression import GradCompressor

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "make_train_step",
           "TrainState", "save_checkpoint", "load_checkpoint",
           "GradCompressor"]
