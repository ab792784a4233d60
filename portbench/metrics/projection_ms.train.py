"""Device ms a view of projection and SH in training (``ops/render.py::
project_and_shade``, forward and backward): the device time of the traced
stretch put down to the spans ``render.project_sh`` and
``render.project_sh.bwd`` (``portbench/spans.py``), over its views."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.per_unit_ms(layer, ("render.project_sh", "render.project_sh.bwd"), True)
