"""Share of the traced stretch in which the device is idle while the main
thread is inside the span ``train.step`` (the step's own launches and
waits; ``portbench/spans.py``). Percent."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.idle_share(layer, "train.step")
