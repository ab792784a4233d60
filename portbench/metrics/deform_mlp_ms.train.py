"""Device ms a view of Deformable 3D Gaussians' deformation MLP in training
(``models/deform.py::offsets``, forward and backward): the device time of
the traced stretch put down to the spans ``deform.mlp`` and
``deform.mlp.bwd`` (``portbench/spans.py``), over its views."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train" or not layer.get("deform"):
        return None
    return spans.per_unit_ms(layer, ("deform.mlp", "deform.mlp.bwd"), True)
