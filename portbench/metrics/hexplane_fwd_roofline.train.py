"""Share of its roofline the HexPlane field's forward kernel reaches in
training (``csrc/hexplane.cu``, ``hexplane_fwd_kernel``): the least time
the chip needs for the stretch's launches, by ``work_hexplane.field_fwd``
on the rows the program's counter ``deform.rows`` counted over the stretch
(one launch a view), over the kernel's device time. Percent."""

from portbench import work, work_hexplane

SYMBOLS = ("hexplane_fwd_kernel",)


def read(layer):
    h = layer.get("hexplane")
    t = layer.get("trace")
    if layer.get("kind") != "train" or not h or t is None or not h.get("stretch_rows"):
        return None
    views = t.units * layer["views_per_unit"]
    ops, nbytes = work_hexplane.field_fwd(h["spec"], h["stretch_rows"], views)
    return work.roofline_share(ops, nbytes, t.seconds_of(SYMBOLS))
