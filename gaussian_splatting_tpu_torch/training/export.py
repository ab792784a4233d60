"""Standard 3DGS ``.ply`` export (counterpart of
``gaussian_splatting_tpu/training/export.py``, the same bytes): binary
little-endian, fields x, y, z, nx, ny, nz (= 0), f_dc_0..2, opacity (raw
logit), scale_0..2 (raw log), rot_0..3 (raw quaternion), f_rest_0..44
(``features_rest.reshape(N, -1)`` order, coefficient-major). A surfel
scene (2D Gaussian Splatting, two log-scales a row) writes scale_0 and
scale_1 only.

Plain numpy: the header and the packed body follow the PLY 1.0 spec, so
either package reads what the other wrote.
"""

from __future__ import annotations

import numpy as np

def _props(n_scales: int = 3):
    return (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2", "opacity"]
            + [f"scale_{i}" for i in range(n_scales)] + ["rot_0", "rot_1", "rot_2", "rot_3"]
            + [f"f_rest_{i}" for i in range(45)])


_PROPS = _props()


def write_ply(
    path: str,
    means: np.ndarray,          # (N, 3)
    features_dc: np.ndarray,    # (N, 1, 3) or (N, 3)
    features_rest: np.ndarray,  # (N, 15, 3) (zero-padded/clipped to 45 floats)
    logit_opacities: np.ndarray,  # (N, 1) raw logits
    log_scales: np.ndarray,     # (N, 3) raw log scales, (N, 2) for surfels
    quats: np.ndarray,          # (N, 4) raw (unnormalized) w-first quats
) -> None:
    N = means.shape[0]
    n_scales = np.shape(log_scales)[-1] if N else 3
    fdc = np.asarray(features_dc, np.float32).reshape(N, -1)[:, :3]
    fr = np.asarray(features_rest, np.float32).reshape(N, -1)
    if fr.shape[1] >= 45:
        fr = fr[:, :45]
    else:
        fr = np.concatenate([fr, np.zeros((N, 45 - fr.shape[1]), np.float32)], axis=1)

    mat = np.concatenate(
        [
            np.asarray(means, np.float32).reshape(N, 3),
            np.zeros((N, 3), np.float32),
            fdc,
            np.asarray(logit_opacities, np.float32).reshape(N, 1),
            np.asarray(log_scales, np.float32).reshape(N, n_scales),
            np.asarray(quats, np.float32).reshape(N, 4),
            fr,
        ],
        axis=1,
    ).astype("<f4")

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {N}\n"
        + "".join(f"property float {p}\n" for p in _props(n_scales))
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(mat).tobytes())


def read_ply(path: str) -> dict:
    """Read a 3DGS PLY written by ``write_ply`` (of either package) back
    into raw parameter arrays (numpy, keyed as ``GaussianParams``)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError("truncated PLY header")
            header += line
        lines = header.decode("ascii").splitlines()
        n = None
        props = []
        fmt = None
        for ln in lines:
            if ln.startswith("format"):
                fmt = ln.split()[1]
            elif ln.startswith("element vertex"):
                n = int(ln.split()[-1])
            elif ln.startswith("property float"):
                props.append(ln.split()[-1])
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        data = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4").reshape(n, len(props))
    cols = {p: data[:, i] for i, p in enumerate(props)}

    def stack(names):
        return np.stack([cols[nm] for nm in names], axis=1)

    out = {
        "means": stack(["x", "y", "z"]),
        "features_dc": stack(["f_dc_0", "f_dc_1", "f_dc_2"]).reshape(n, 1, 3),
        "logit_opacities": cols["opacity"].reshape(n, 1),
        "log_scales": stack([p for p in ("scale_0", "scale_1", "scale_2") if p in cols]),
        "quats": stack(["rot_0", "rot_1", "rot_2", "rot_3"]),
    }
    rest_names = [p for p in props if p.startswith("f_rest_")]
    if rest_names:
        rest = stack(sorted(rest_names, key=lambda s: int(s.split("_")[-1])))
        out["features_rest"] = rest.reshape(n, 15, 3)
    else:
        out["features_rest"] = np.zeros((n, 15, 3), np.float32)
    return out


def export_state_ply(state, path: str) -> int:
    """Export the alive gaussians of a ``GaussianState`` (tensors on any
    device) to PLY; returns how many were written."""
    def npy(t):
        return t.detach().cpu().numpy()

    idx = np.nonzero(npy(state.alive))[0]
    p = state.params
    write_ply(path, *(npy(getattr(p, k))[idx] for k in (
        "means", "features_dc", "features_rest", "logit_opacities", "log_scales", "quats")))
    return len(idx)
