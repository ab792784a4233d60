"""Device ms a frame of the viewer's binning (dense: the keys, the sort and
``pack_soa``): the stretch's device time under the span
``render.binning``, over its frames."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "render":
        return None
    return spans.per_unit_ms(layer, ("render.binning",), True)
