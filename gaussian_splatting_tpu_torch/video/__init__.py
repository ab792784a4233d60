from gaussian_splatting_tpu_torch.video.loader import VideoLoader
from gaussian_splatting_tpu_torch.video.calibrate import Calibrator
from gaussian_splatting_tpu_torch.video.sfm import VideoSfM
from gaussian_splatting_tpu_torch.video.processor import MultiVideoProcessor

__all__ = ["VideoLoader", "Calibrator", "VideoSfM", "MultiVideoProcessor"]
