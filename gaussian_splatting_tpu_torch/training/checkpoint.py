"""Checkpoints with resume (counterpart of ``gaussian_splatting_tpu/training/
checkpoint.py``): one ``.npz`` with the full training state under the JAX
package's keys (``models.gaussians.train_state_to_numpy``) plus the JSON
metadata, so either package reads what the other wrote.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.models.gaussians import (
    train_state_from_numpy,
    train_state_to_numpy,
)


def save_checkpoint(path: str, state, extra: Optional[dict] = None) -> None:
    """Write ``state`` (a ``training.step.TrainState``) and the metadata
    ``extra`` to ``path``, atomically (through ``path + '.tmp'``)."""
    arrays = train_state_to_numpy(state)
    arrays["meta_json"] = np.frombuffer(json.dumps(extra or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, device: DeviceLike = None) -> Tuple[object, dict]:
    """(TrainState on ``device`` (CUDA unless given), metadata dict) from a
    ``.npz`` checkpoint written by either package."""
    dev = resolve_device(device)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "meta_json"}
        meta_raw = bytes(z["meta_json"].tobytes()).decode() if "meta_json" in z else ""
    return train_state_from_numpy(arrays, dev), json.loads(meta_raw or "{}")
