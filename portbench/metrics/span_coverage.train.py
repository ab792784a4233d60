"""Share of the traced stretch's device time whose innermost span is a
stage span: anything but ``train.step`` itself, ``step.backward`` itself,
no span, or no launch found (``portbench/spans.py``). Percent."""


def read(layer):
    a = layer.get("span_stretch")
    if layer.get("kind") != "train" or a is None:
        return None
    return a.coverage(("train.step", "step.backward"))
