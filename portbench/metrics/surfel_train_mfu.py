"""The whole surfel training step's share of the chip's float32 peak:
``work_surfel.train_step_flops`` (the projection pair, the raster pairs'
pairs forward and backward, the photometric loss and the two regularizers
a pixel, Adam a surfel's parameters) times the steps of the run's measured
window, over the window's length on the host's clock times 67 TFLOP/s. The
window comes before the profiled stretch. Percent."""

from portbench import work, work_surfel


def read(layer):
    if (layer.get("kind") != "train" or not layer.get("surfel") or not layer.get("window_s")
            or not layer.get("units")):
        return None
    flops = layer["units"] * work_surfel.train_step_flops(
        layer["view"], layer["n_gaussians"], layer["views_per_unit"], layer["sh_degree"])
    return 100.0 * flops / (layer["window_s"] * work.PEAK_FP32_FLOPS)
