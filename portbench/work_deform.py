"""Operation counts of Deformable 3D Gaussians' deformation MLP, a row and a
view: the published network (D linears of width W, the encodings fed again
after linear ``skip``, three heads of 3, 4 and 3 outputs), from the
configuration's ``deform`` section. A multiply-add counts two operations.
The encodings and the ReLUs are left out (elementwise, under 1 % of the
products)."""

from __future__ import annotations

from portbench import work


def in_channels(spec: dict) -> int:
    return 3 * (1 + 2 * spec["multires_x"]) + 1 + 2 * spec["multires_t"]


def macs_per_row(spec: dict) -> int:
    """Multiply-adds of one row's forward: 504,320 at D 8, W 256, L 10, 10
    (84 W + 4 W^2 + (W + 84) W + 2 W^2 + 10 W)."""
    c, w = in_channels(spec), spec["width"]
    macs = 0
    for i in range(spec["depth"]):
        fan_in = c if i == 0 else w + c if i == spec["skip"] + 1 else w
        macs += fan_in * w
    return macs + w * 10


def mlp_train_flops(spec: dict, rows: float) -> float:
    """The forward, the weight gradients (each 2 x the multiply-adds) and
    the input gradients of every linear but the first (its input, the
    encodings, needs none): 2.98 MFLOP a row at the published shape."""
    m = macs_per_row(spec)
    m_in = m - in_channels(spec) * spec["width"]
    return (2 * m + 2 * m + 2 * m_in) * rows


def n_params(spec: dict) -> int:
    """The network's parameters: weights and biases."""
    c, w = in_channels(spec), spec["width"]
    n = 0
    for i in range(spec["depth"]):
        fan_in = c if i == 0 else w + c if i == spec["skip"] + 1 else w
        n += fan_in * w + w
    return n + 10 * w + 10


def train_step_flops(layer: dict) -> float:
    """One deformable training step: ``work.train_step_flops`` of the
    static step at the cell's batch, plus the MLP over the alive rows of
    each view and its Adam."""
    spec = layer["deform"]["spec"]
    rows = layer["deform"]["rows_per_view"] or layer["n_gaussians"]
    b = layer["views_per_unit"]
    return (work.train_step_flops(layer["view"], layer["n_gaussians"], b, layer["sh_degree"])
            + b * mlp_train_flops(spec, rows) + work.ADAM_FLOPS * n_params(spec))
