"""Share of the traced run's window the trainer spends in its host-cadenced
events: densify, capacity growth, the budget and tile-cap watchdogs, the
grad-buffer probe, validation and the log writes, each timed on the host
with the device synchronized on both sides by the benchmark's subclass of
``GaussianTrainer`` (``training/trainer.py``). Percent."""


def read(layer):
    if layer.get("kind") != "train" or not layer.get("window_s"):
        return None
    return 100.0 * sum(layer["event_s"].values()) / layer["window_s"]
