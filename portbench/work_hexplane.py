"""Operation and byte counts of 4D Gaussian Splatting's HexPlane field and
decoder, a row and a launch, from the configuration's ``hexplane`` section;
the static step's from ``work.py``. A multiply-add counts two operations.

The field's counts hold only what every implementation must do: the
arithmetic, and in HBM each row's coordinates read and its feature written
(the backward: the coordinates and the feature's gradient read, the
coordinates' gradient written) and the planes read once a launch (the
backward also writes their gradient once). The corner reads and the
scattered adds are served by L2 (the table is 9.5 MB at the published
widths) and are not counted as HBM bytes, so a share of the roofline cannot
pass 100 %.
"""

from __future__ import annotations

from portbench import work

# The forward a plane and row: the two coordinates unnormalised (3 each),
# the cell weights (3 each), the four corner weights (4); a channel's
# bilinear sum (4 multiplies, 3 adds) and its product with the scale's
# running feature (1).
FWD_FLOPS_PER_PLANE = 6 + 6 + 4
FWD_FLOPS_PER_CHANNEL = 8
# The backward a plane and row, the samples taken as given: the weights
# (16); a channel's product gradients (2), the four corners' weighted
# gradients and their adds (8), the coordinate gradients' corner differences
# (4), products and sums (8).
BWD_FLOPS_PER_PLANE = 16
BWD_FLOPS_PER_CHANNEL = 2 + 8 + 4 + 8
# Bytes a row: coordinates (3 floats) and the time share one read; the
# feature is 2C floats.
COORD_BYTES = 3 * 4


def n_planes(spec: dict) -> int:
    return 6 * len(spec["multires"])


def plane_floats(spec: dict) -> int:
    """The planes' floats: 2,365,440 at the published widths."""
    C, res = spec["channels"], spec["resolution"]
    out = 0
    for m in spec["multires"]:
        r = [x * m for x in res[:3]] + [res[3]]
        out += sum(r[i] * r[j] for i in range(4) for j in range(i + 1, 4))
    return C * out


def feature_bytes(spec: dict) -> int:
    return 4 * spec["channels"] * len(spec["multires"])


def field_fwd(spec: dict, rows: float, launches: float):
    """(operations, bytes) of the forward over ``rows`` rows in
    ``launches`` launches."""
    ops = n_planes(spec) * (FWD_FLOPS_PER_PLANE + spec["channels"] * FWD_FLOPS_PER_CHANNEL)
    nbytes = (COORD_BYTES + feature_bytes(spec)) * rows + 4 * plane_floats(spec) * launches
    return ops * rows, nbytes


def field_bwd(spec: dict, rows: float, launches: float):
    """(operations, bytes) of the backward over ``rows`` rows in
    ``launches`` launches."""
    ops = n_planes(spec) * (BWD_FLOPS_PER_PLANE + spec["channels"] * BWD_FLOPS_PER_CHANNEL)
    nbytes = ((2 * COORD_BYTES + feature_bytes(spec)) * rows
              + 2 * 4 * plane_floats(spec) * launches)
    return ops * rows, nbytes


def decoder_macs(spec: dict) -> int:
    """Multiply-adds of one row through the decoder: 14,976 at the
    published widths (2C W + 3 W^2 + 10 W)."""
    W = spec["net_width"]
    heads = sum(spec["heads"].values())
    return 2 * spec["channels"] * W + len(spec["heads"]) * W * W + heads * W


def decoder_params(spec: dict) -> int:
    W = spec["net_width"]
    heads = sum(spec["heads"].values())
    return (2 * spec["channels"] * W + W + len(spec["heads"]) * (W * W + W)
            + heads * W + heads)


def row_train_flops(spec: dict) -> float:
    """A row's field forward and backward and the decoder's forward, weight
    gradients and input gradients (the field needs the feature's)."""
    f_ops = n_planes(spec) * (FWD_FLOPS_PER_PLANE + BWD_FLOPS_PER_PLANE + spec["channels"]
                              * (FWD_FLOPS_PER_CHANNEL + BWD_FLOPS_PER_CHANNEL))
    return f_ops + 6 * decoder_macs(spec)


def train_step_flops(layer: dict) -> float:
    """One 4DGS training step: ``work.train_step_flops`` of the static step
    at the cell's batch, the field and decoder over the alive rows of each
    view, the regularizers (about 12 operations a plane float, forward and
    backward) and Adam of the field's tensors."""
    h = layer["hexplane"]
    spec = h["spec"]
    rows = h["rows_per_view"] or layer["n_gaussians"]
    b = layer["views_per_unit"]
    return (work.train_step_flops(layer["view"], layer["n_gaussians"], b, layer["sh_degree"])
            + b * rows * row_train_flops(spec) + 12 * plane_floats(spec)
            + work.ADAM_FLOPS * (plane_floats(spec) + decoder_params(spec)))
