"""Device ms a view of 2D Gaussian Splatting's normal-consistency and
depth-distortion terms in training (``training/loss.py::surfel_terms``,
forward and backward): the device time of the traced stretch put down to
the spans ``step.surfel_reg`` and ``step.surfel_reg.bwd``
(``portbench/spans.py``), over its views."""

from portbench import spans


def read(layer):
    if layer.get("kind") != "train" or not layer.get("surfel"):
        return None
    return spans.per_unit_ms(layer, ("step.surfel_reg", "step.surfel_reg.bwd"), True)
