"""Share of its roofline the backward raster stage reaches in training
(``csrc/rasterize_bwd.cu``, ``csrc/rasterize_bwd_q.cu`` and the stream's
tail in ``csrc/raster_tiles.cuh``): the least time the chip needs for the
stretch's views, by ``work.raster_bwd`` on the reference's counts of the
cell's views, over the device time of the kernels below. Percent."""

from portbench import work

SYMBOLS = ("rasterize_bwd_kernel", "rasterize_bwd_q_kernel", "rasterize_bwd_tail_kernel")


def read(layer):
    t = layer.get("trace")
    if layer.get("kind") != "train" or t is None:
        return None
    v = layer["view"]
    views = t.units * layer["views_per_unit"]
    ops, nbytes = work.raster_bwd(v["n_isect"], v["pairs"], v["pixels"], v["tiles"])
    return work.roofline_share(views * ops, views * nbytes, t.seconds_of(SYMBOLS))
