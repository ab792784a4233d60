"""Share of the traced stretch of frames in which the device is idle while
the host is inside the span ``render.frame`` (``ops/facade.py::
render_single``). Percent."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "render":
        return None
    return spans.idle_share(layer, "render.frame")
