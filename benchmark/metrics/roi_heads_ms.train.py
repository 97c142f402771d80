"""Device milliseconds a training step in the ROI heads' forward: the
model.box_head and model.cube_head spans (ROIAlign, the heads, the cube
decode, their losses), idle inside them included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("model.box_head", "model.cube_head"),
                       "device_ms", "steps")
