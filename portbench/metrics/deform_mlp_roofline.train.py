"""The deformation MLP's share of the chip's float32 peak in training: its
operations a view on the rows it took (``work_deform.mlp_train_flops``: the
forward, the weight gradients and the input gradients, 2.98 MFLOP a row at
the published shape; the rows read from the program's counter
``deform.rows`` over the stretch) over 67 TFLOP/s, over its device ms a
view under ``deform.mlp`` + ``deform.mlp.bwd``. Percent."""

from portbench import spans, work, work_deform


def read(layer):
    d = layer.get("deform")
    if layer.get("kind") != "train" or not d or not d.get("rows_per_view"):
        return None
    ms = spans.per_unit_ms(layer, ("deform.mlp", "deform.mlp.bwd"), True)
    if not ms:
        return None
    flops = work_deform.mlp_train_flops(d["spec"], d["rows_per_view"])
    return 100.0 * flops / work.PEAK_FP32_FLOPS / (ms * 1e-3)
