"""PyTorch/CUDA port of ``gaussian_splatting_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference each module is held
against. This package imports ``torch`` and never ``jax`` or anything of
``gaussian_splatting_tpu``. Its layout mirrors the JAX package so a module's
counterpart is easy to find:

- ``core/``     activations, quaternions, spherical harmonics, cameras
- ``ops/``      projection, tile binning, the torch oracle, the CUDA
                rasterizer, render and the facade
- ``models/``   the gaussian parameter container
- ``training/`` checkpoint reading
- ``csrc/``     the hand-written Hopper kernels (built on first use by
                ``ops/_build.py``)

Entry points run on ``torch.device("cuda")`` unless the caller passes
another device; without CUDA they raise instead of quietly using the CPU.
"""
