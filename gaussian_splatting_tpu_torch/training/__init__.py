from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from gaussian_splatting_tpu_torch.training.config import TrainingConfig
from gaussian_splatting_tpu_torch.training.step import (
    PoseState,
    TrainState,
    ViewBatch,
    make_train_step,
    pose_state_init,
)

__all__ = ["load_checkpoint", "save_checkpoint", "TrainingConfig", "PoseState",
           "TrainState", "ViewBatch", "make_train_step", "pose_state_init"]
