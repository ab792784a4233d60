from gaussian_splatting_tpu_torch.core.activations import (
    opacity_activation,
    opacity_inverse_activation,
    scale_activation,
    scale_inverse_activation,
)
from gaussian_splatting_tpu_torch.core.cameras import (
    Camera,
    focal_from_heuristic,
    look_at,
    make_intrinsics,
)
from gaussian_splatting_tpu_torch.core.quaternions import quat_normalize, quat_to_rotmat
from gaussian_splatting_tpu_torch.core.sh import (
    eval_sh,
    num_sh_bases,
    rgb_to_sh0,
    sh0_to_rgb,
    sh_to_color,
)

__all__ = [
    "Camera",
    "focal_from_heuristic",
    "make_intrinsics",
    "look_at",
    "quat_normalize",
    "quat_to_rotmat",
    "eval_sh",
    "sh_to_color",
    "num_sh_bases",
    "rgb_to_sh0",
    "sh0_to_rgb",
    "scale_activation",
    "scale_inverse_activation",
    "opacity_activation",
    "opacity_inverse_activation",
]
