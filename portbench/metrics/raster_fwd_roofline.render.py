"""Share of its roofline the forward raster stage reaches in rendering
(``csrc/rasterize_fwd.cu``, ``csrc/rasterize_fwd_q.cu``): the least time
the chip needs for the stretch's frames, by ``work.raster_fwd`` on the
reference's counts of the cell's views, over the device time of the kernels
below. Percent."""

from portbench import work

SYMBOLS = ("rasterize_fwd_kernel", "rasterize_fwd_q_kernel")


def read(layer):
    t = layer.get("trace")
    if layer.get("kind") != "render" or t is None:
        return None
    v = layer["view"]
    views = t.units * layer["views_per_unit"]
    ops, nbytes = work.raster_fwd(v["n_isect"], v["pairs"], v["pixels"], v["tiles"])
    return work.roofline_share(views * ops, views * nbytes, t.seconds_of(SYMBOLS))
