"""Device activities (kernels, memsets, copies) per frame of
``GaussianRasterizer.render_single`` (``ops/facade.py`` -> ``ops/render.py``),
counted by the profiler over the traced stretch."""


def read(layer):
    t = layer.get("trace")
    if layer.get("kind") != "render" or t is None or not t.units:
        return None
    return len(t.names) / t.units
