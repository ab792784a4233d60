from gaussian_splatting_tpu_torch.models.gaussians import (
    GaussianParams,
    GaussianState,
    empty_state,
    state_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)

__all__ = ["GaussianParams", "GaussianState", "empty_state", "state_from_numpy",
           "train_state_from_numpy", "train_state_to_numpy"]
