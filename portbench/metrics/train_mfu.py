"""The whole training step's share of the chip's float32 peak: the step's
floating-point work at the active SH degree (``work.train_step_flops``:
projection and SH per gaussian and view, the blend's pairs forward and
backward, the loss per pixel, Adam per parameter) times the steps of the
run's measured window, over the window's length on the host's clock times
67 TFLOP/s. The window comes before the profiled stretch, so the profiler's
own cost is not in it. Percent."""

from portbench import work


def read(layer):
    if layer.get("kind") != "train" or not layer.get("window_s") or not layer.get("units"):
        return None
    flops = layer["units"] * work.train_step_flops(layer["view"], layer["n_gaussians"],
                                                   layer["views_per_unit"], layer["sh_degree"])
    return 100.0 * flops / (layer["window_s"] * work.PEAK_FP32_FLOPS)
