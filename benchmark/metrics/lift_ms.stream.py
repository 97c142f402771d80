"""Device milliseconds an image in the cube model on the 2D slots (span
lift: the trunk, the pyramid, ROIAlign, the cube head), idle inside
included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("lift",), "device_ms", "images")
