"""Training summary plots from ``metrics.jsonl`` (counterpart of
``gaussian_splatting_tpu/utils/plots.py``): loss, gaussian count, train and
val PSNR in one ``training_summary.png``. Needs matplotlib; the trainer
treats a failure here as a warning."""

import json
import os


def draw_graphs(metrics_path: str, out_dir: str | None = None) -> list:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = out_dir or os.path.dirname(metrics_path)
    rows = []
    with open(metrics_path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue

    def series(key):
        xs, ys = [], []
        for r in rows:
            if key in r and r.get("_step") is not None:
                xs.append(r["_step"])
                ys.append(r[key])
        return xs, ys

    panels = [
        ("loss", "Training loss", "log"),
        ("n_gaussians", "Gaussian count", "linear"),
        ("train/psnr", "Train PSNR (dB)", "linear"),
        ("val/psnr", "Val PSNR (dB)", "linear"),
    ]
    written = []
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    for ax, (key, title, scale) in zip(axes.ravel(), panels):
        xs, ys = series(key)
        if xs:
            ax.plot(xs, ys, linewidth=1)
            ax.set_yscale(scale)
        ax.set_title(title)
        ax.set_xlabel("iteration")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    path = os.path.join(out_dir, "training_summary.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    written.append(path)
    return written
