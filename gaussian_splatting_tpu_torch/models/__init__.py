from gaussian_splatting_tpu_torch.models.gaussians import (
    GaussianParams,
    GaussianState,
    empty_state,
    state_from_numpy,
)

__all__ = ["GaussianParams", "GaussianState", "empty_state", "state_from_numpy"]
