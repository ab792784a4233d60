from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint

__all__ = ["load_checkpoint"]
