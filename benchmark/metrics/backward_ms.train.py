"""Device milliseconds a training step in autograd's backward: the
train.backward span (the `torch.autograd.grad` call), idle inside it
included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("train.backward",), "device_ms", "steps")
