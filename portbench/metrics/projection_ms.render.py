"""Device ms a frame of projection and SH in the viewer
(``ops/render.py::project_and_shade``): the stretch's device time under the
span ``render.project_sh``, over its frames."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "render":
        return None
    return spans.per_unit_ms(layer, ("render.project_sh",), True)
