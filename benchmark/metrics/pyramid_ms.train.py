"""Device milliseconds a training step in the pyramid: the model.pyramid
spans (SFP, SAM's neck), the forward alone (their backward runs in
train.backward), idle inside them included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("model.pyramid",), "device_ms", "steps")
