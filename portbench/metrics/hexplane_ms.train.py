"""Device ms a view of 4D Gaussian Splatting's HexPlane field in training
(``models/hexplane.py::offsets``, the kernel pair ``csrc/hexplane.cu``,
forward and backward): the device time of the traced stretch put down to
the spans ``deform.field`` and ``deform.field.bwd``
(``portbench/spans.py``), over its views."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train" or not layer.get("hexplane"):
        return None
    return spans.per_unit_ms(layer, ("deform.field", "deform.field.bwd"), True)
