"""Share of its roofline the surfel projection pair reaches in training
(``csrc/project_sh.cu``, ``project_surfel_fwd_kernel`` and
``project_surfel_bwd_kernel``): the least time the chip needs for the
stretch's views, by ``work_surfel.projection`` on the checkpoint's alive
surfels at the cell's SH degree, over the two kernels' device time. The
kernels run over every slot of the buffer, the dead ones too; the work
counts the alive ones. Percent."""

from portbench import work, work_surfel

SYMBOLS = ("project_surfel_fwd_kernel", "project_surfel_bwd_kernel")


def read(layer):
    t = layer.get("trace")
    if layer.get("kind") != "train" or not layer.get("surfel") or t is None:
        return None
    views = t.units * layer["views_per_unit"]
    ops, nbytes = work_surfel.projection(layer["n_gaussians"], layer["sh_degree"])
    return work.roofline_share(views * ops, views * nbytes, t.seconds_of(SYMBOLS))
