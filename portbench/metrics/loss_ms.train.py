"""Device ms a view of the photometric loss (``training/loss.py``, L1 and
SSIM, forward and backward): the stretch's device time under the spans
``step.loss`` and ``step.loss.bwd``, over its views."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.per_unit_ms(layer, ("step.loss", "step.loss.bwd"), True)
