"""Device ms a view of binning in training (``ops/rasterize_cuda.py::
_binned``: the keys, the sort and ``pack_soa``, on the cell's binning
mode): the stretch's device time under the span ``render.binning``, over
its views."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.per_unit_ms(layer, ("render.binning",), True)
