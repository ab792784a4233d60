"""Checkpoint reading (counterpart of ``gaussian_splatting_tpu/training/
checkpoint.py``, read side).

Reads the ``.npz`` the JAX package's ``save_checkpoint`` writes: the six
parameter arrays under ``params/``, the ``alive`` mask, the densification
accumulators and the JSON metadata. The Adam moments, iteration counter and
pose corrections are left for the training slice.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np

from gaussian_splatting_tpu_torch._device import DeviceLike
from gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_KEYS,
    GaussianState,
    state_from_numpy,
)

_STATE_KEYS = ("alive", "xyz_grad_accum", "xyz_grad_count", "max_radii2d")


def load_checkpoint(path: str, device: DeviceLike = None) -> Tuple[GaussianState, dict]:
    """(GaussianState on ``device``, metadata dict) from a JAX ``.npz``
    checkpoint."""
    with np.load(path) as z:
        arrays = {k: z[f"params/{k}"] for k in PARAM_KEYS}
        arrays.update({k: z[k] for k in _STATE_KEYS if k in z})
        meta_raw = bytes(z["meta_json"].tobytes()).decode() if "meta_json" in z else ""
    return state_from_numpy(arrays, device), json.loads(meta_raw or "{}")
