"""Metrics logging with a W&B-compatible schema (counterpart of
``gaussian_splatting_tpu/utils/metrics.py``, the same file layout and keys).

The sink is an append-only ``metrics.jsonl`` beside ``config.json``, always
written; a wandb mirror with the same keys runs only when ``wandb_mode`` is
not ``"disabled"`` and the package imports. Scalar keys: loss, train/l1,
train/ssim, train/psnr, densify/*, val/*, stats/*; images go to ``images/``
as PNG (PIL), histograms into the JSONL as bin counts."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger(__name__)


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class MetricsLogger:
    def __init__(self, out_dir: str, config: Optional[dict] = None,
                 wandb_mode: str = "disabled", wandb_project: str = "",
                 wandb_entity=None, wandb_run_name=None, wandb_tags=None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self.wandb_run = None
        if wandb_mode != "disabled":
            try:
                import wandb

                self.wandb_run = wandb.init(
                    project=wandb_project, entity=wandb_entity,
                    name=wandb_run_name, tags=wandb_tags, mode=wandb_mode,
                    config=config,
                )
            except Exception as e:  # mirror the reference's disabled fallback
                log.warning("wandb init failed (%s); JSONL only", e)
        if config is not None:
            with open(os.path.join(out_dir, "config.json"), "w") as f:
                json.dump({k: _to_py(v) for k, v in config.items()}, f, indent=2, default=str)

    def log(self, data: Dict, step: Optional[int] = None) -> None:
        rec = {k: _to_py(v) for k, v in data.items()}
        rec["_step"] = int(step) if step is not None else None
        rec["_wall"] = round(time.time() - self._t0, 3)
        self._f.write(json.dumps(rec) + "\n")
        if self.wandb_run is not None:
            try:
                self.wandb_run.log(data, step=step)
            except Exception as e:
                log.warning("wandb log failed: %s", e)

    def log_image(self, name: str, image, step: Optional[int] = None) -> None:
        """Save a PNG under images/ and reference it from the JSONL."""
        import numpy as np
        from PIL import Image

        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        fname = f"{name.replace('/', '_')}_{step if step is not None else 0}.png"
        fpath = os.path.join(img_dir, fname)
        Image.fromarray(arr).save(fpath)
        self.log({f"image/{name}": fpath}, step=step)
        if self.wandb_run is not None:
            try:
                import wandb

                self.wandb_run.log({name: wandb.Image(arr)}, step=step)
            except Exception:
                pass

    def log_histogram(self, name: str, values, step: Optional[int] = None,
                      bins: int = 64) -> None:
        """Real parameter histograms (reference logs these every 5k iters,
        ``trainer.py:931-948``): bin edges + counts into the JSONL, mirrored
        as a native wandb.Histogram when live."""
        import numpy as np

        arr = np.asarray(values).ravel()
        arr = arr[np.isfinite(arr)]
        if arr.size == 0:
            return
        counts, edges = np.histogram(arr, bins=bins)
        self.log({
            f"hist/{name}": {
                "counts": counts.tolist(),
                "min": float(edges[0]),
                "max": float(edges[-1]),
                "n": int(arr.size),
            }
        }, step=step)
        if self.wandb_run is not None:
            try:
                import wandb

                self.wandb_run.log(
                    {name: wandb.Histogram(np_histogram=(counts, edges))},
                    step=step)
            except Exception:
                pass

    def log_artifact(self, path: str, name: str, kind: str = "model") -> None:
        """Record a produced artifact (checkpoint/PLY) in the JSONL and, when
        wandb is live, upload it (reference ``train.py:144-155``)."""
        self.log({f"artifact/{kind}": path})
        if self.wandb_run is not None:
            try:
                import wandb

                art = wandb.Artifact(name, type=kind)
                art.add_file(path)
                self.wandb_run.log_artifact(art)
            except Exception as e:
                log.warning("wandb artifact failed: %s", e)

    def finish(self) -> None:
        self._f.close()
        if self.wandb_run is not None:
            try:
                self.wandb_run.finish()
            except Exception:
                pass


class NullLogger:
    """A logger that writes nothing: the trainer's logger on the ranks of a
    mesh other than rank 0, which alone writes files."""

    path = None

    def log(self, *args, **kwargs) -> None:
        pass

    log_image = log_histogram = log_artifact = log

    def finish(self) -> None:
        pass
