"""Device ms a step of the optimizer block of ``training/step.py`` (Adam,
the scale clamp, the densify accumulators, the gradient norms, the pose
Adam): the stretch's device time under the span ``step.adam``, over its
steps."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.per_unit_ms(layer, ("step.adam",), False)
