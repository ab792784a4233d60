"""The whole frame's share of the chip's float32 peak: the frame's
floating-point work (``work.render_frame_flops``: projection and SH per
gaussian, the blend's pairs) times the frames of the run's measured window,
over the window's length on the host's clock times 67 TFLOP/s. The window
comes before the profiled stretch, so the profiler's own cost is not in
it. Percent."""

from portbench import work


def read(layer):
    if layer.get("kind") != "render" or not layer.get("window_s") or not layer.get("units"):
        return None
    flops = layer["units"] * work.render_frame_flops(layer["view"], layer["n_gaussians"],
                                                     layer["sh_degree"])
    return 100.0 * flops / (layer["window_s"] * work.PEAK_FP32_FLOPS)
