"""Device ms a view of 4D Gaussian Splatting's decoder in training (the
64-wide linears after the HexPlane field, forward and backward): the
device time of the traced stretch put down to the spans ``deform.mlp`` and
``deform.mlp.bwd`` (``portbench/spans.py``), over its views."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train" or not layer.get("hexplane"):
        return None
    return spans.per_unit_ms(layer, ("deform.mlp", "deform.mlp.bwd"), True)
