"""Parameter activations (counterpart of ``gaussian_splatting_tpu/core/
activations.py``): scales stored in log-space (exp activation), opacity in
logit-space (sigmoid activation), rotations L2-normalized elsewhere.
"""

import torch


def scale_activation(log_scales: torch.Tensor) -> torch.Tensor:
    return torch.exp(log_scales)


def scale_inverse_activation(scales: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return torch.log(torch.clamp_min(scales, eps))


def opacity_activation(logit_op: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(logit_op)


def opacity_inverse_activation(op: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    op = torch.clamp(op, eps, 1.0 - eps)
    return torch.log(op) - torch.log1p(-op)
