"""Device milliseconds an image in the deformable sampling calls of the encoder
and the decoder (spans gdino.deformable), idle inside included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("gdino.deformable",), "device_ms", "images")
