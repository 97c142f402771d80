"""Device milliseconds an image in the six enhancer layers: fusion, text and
deformable image layers (span gdino.encoder), idle inside included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("gdino.encoder",), "device_ms", "images")
