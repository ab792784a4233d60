"""The whole 4D Gaussian Splatting training step's share of the chip's
float32 peak: ``work_hexplane.train_step_flops`` (the static step at the
cell's batch, the field and decoder over the alive rows of each view, the
regularizers, the field's Adam) times the steps of the run's measured
window, over the window's length on the host's clock times 67 TFLOP/s.
The window comes before the profiled stretch. Percent."""

from portbench import work, work_hexplane


def read(layer):
    if (layer.get("kind") != "train" or not layer.get("hexplane") or not layer.get("window_s")
            or not layer.get("units")):
        return None
    flops = layer["units"] * work_hexplane.train_step_flops(layer)
    return 100.0 * flops / (layer["window_s"] * work.PEAK_FP32_FLOPS)
