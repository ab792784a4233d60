"""Share of its roofline the surfel forward raster kernel reaches in
training (``csrc/rasterize_surfel.cu``, ``surfel_fwd_kernel``): the least
time the chip needs for the stretch's views, by ``work_surfel.raster_fwd``
on the surfel reference's counts of the cell's views, over the kernel's
device time. Percent."""

from portbench import work, work_surfel

SYMBOLS = ("surfel_fwd_kernel",)


def read(layer):
    t = layer.get("trace")
    if layer.get("kind") != "train" or not layer.get("surfel") or t is None:
        return None
    v = layer["view"]
    views = t.units * layer["views_per_unit"]
    ops, nbytes = work_surfel.raster_fwd(v["n_isect"], v["pairs"], v["pixels"], v["tiles"])
    return work.roofline_share(views * ops, views * nbytes, t.seconds_of(SYMBOLS))
