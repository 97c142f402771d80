"""Device milliseconds an image in the Swin-B trunk (span gdino.swin),
idle inside included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("gdino.swin",), "device_ms", "images")
