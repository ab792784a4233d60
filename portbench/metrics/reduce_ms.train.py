"""Device ms a view of the gradient reduce (``tiling.reduce_padded_grads``
and the three stacks after it, in ``_RasterizeTiled.backward``): the
stretch's device time under the span ``render.reduce``, over its views."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.per_unit_ms(layer, ("render.reduce",), True)
