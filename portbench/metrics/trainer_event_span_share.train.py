"""Share of the measured window the trainer's main thread spends in its
event spans (``training/trainer.py``: ``train.densify``, ``train.grow``,
``train.watch_budgets``, ``train.watch_tile_cap``,
``train.probe_grad_buffer``, ``train.validate``, ``train.histograms``,
``train.checkpoint`` and ``train.log``, whose scalar reads wait for the
device), with spans on and no profiler. Percent."""

EVENTS = ("train.densify", "train.grow", "train.watch_budgets", "train.watch_tile_cap",
          "train.probe_grad_buffer", "train.validate", "train.histograms",
          "train.checkpoint", "train.log")


def read(layer):
    got = layer.get("span_window_s")
    if layer.get("kind") != "train" or got is None or not layer.get("window_s"):
        return None
    return 100.0 * sum(got.get(n, 0.0) for n in EVENTS) / layer["window_s"]
