"""Device milliseconds an image in the query selection, the six decoder layers
and the heads (span gdino.decoder), idle inside included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("gdino.decoder",), "device_ms", "images")
