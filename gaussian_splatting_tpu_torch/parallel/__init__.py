from gaussian_splatting_tpu_torch.parallel.mesh import init_multihost, make_mesh
from gaussian_splatting_tpu_torch.parallel.sharded_step import (
    make_sharded_train_step,
    pad_images_for_bands,
)

__all__ = ["make_mesh", "init_multihost", "make_sharded_train_step", "pad_images_for_bands"]
