"""Device milliseconds an oracle batch in the cube head: the
model.cube_head span (ROIAlign, the cube head, the decode, the scores),
idle inside it included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("model.cube_head",), "device_ms", "requests")
