"""Projection, tile binning, the PyTorch oracle, the CUDA rasterizer, render
and the facade. Kernels are built and imported lazily: importing a module
here builds nothing."""
