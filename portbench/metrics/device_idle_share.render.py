"""Share of the traced stretch of frames in which no device activity runs:
1 - the union of the activities' intervals over the stretch. Percent."""


def read(layer):
    t = layer.get("trace")
    if layer.get("kind") != "render" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
