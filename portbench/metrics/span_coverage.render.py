"""Share of the traced stretch's device time whose innermost span is a
stage span: anything but ``render.frame`` itself, no span, or no launch
found (``portbench/spans.py``). Percent."""


def read(layer):
    a = layer.get("span_stretch")
    if layer.get("kind") != "render" or a is None:
        return None
    return a.coverage(("render.frame",))
