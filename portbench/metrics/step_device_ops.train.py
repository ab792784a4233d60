"""Device activities (kernels, memsets, copies) per training step of
``training/step.py``, counted by the profiler over the traced stretch."""


def read(layer):
    t = layer.get("trace")
    if layer.get("kind") != "train" or t is None or not t.units:
        return None
    return len(t.names) / t.units
