"""Checkpoints with resume (counterpart of ``gaussian_splatting_tpu/training/
checkpoint.py``): one ``.npz`` with the full training state under the JAX
package's keys (``models.gaussians.train_state_to_numpy``) plus the JSON
metadata, so either package reads what the other wrote; and
``load_reference_pth`` for reference-style torch ``.pth`` state dicts.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.models.gaussians import (
    state_from_numpy,
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


def load_reference_pth(path: str, device: DeviceLike = None):
    """A ``GaussianState`` on ``device`` (CUDA unless given), every gaussian
    alive, from a reference-format torch checkpoint: ``{iteration,
    model_state, optimizer_state, n_gaussians}`` or a bare state dict,
    under any of the key aliases the JAX package's loader takes
    (``checkpoint.py:83``). A single scale column is repeated to three."""
    import torch

    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt
    if isinstance(ckpt, dict):
        for k in ("model_state", "state_dict"):
            if k in ckpt and isinstance(ckpt[k], dict):
                sd = ckpt[k]
                break

    def get(*names):
        for nm in names:
            if nm in sd:
                v = sd[nm]
                return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        return None

    xyz = get("xyz", "means3D", "positions", "points")
    n = xyz.shape[0]
    frest = get("features_rest", "f_rest", "sh_rest")
    frest = (frest.reshape(n, -1, 3)[:, :15] if frest is not None
             else np.zeros((n, 15, 3), np.float32))
    sc = get("scaling", "scales", "log_scales").reshape(n, -1)
    if sc.shape[1] == 1:
        sc = np.repeat(sc, 3, axis=1)
    return state_from_numpy({
        "means": xyz, "features_dc": get("features_dc", "f_dc", "dc").reshape(n, 1, 3),
        "features_rest": frest,
        "logit_opacities": get("opacity", "opacities", "logit_opacity").reshape(n, 1),
        "log_scales": sc, "quats": get("rotation", "rotations", "quat").reshape(n, 4),
    }, dev)
