"""Device milliseconds a training step in the update: the train.optimizer
span (the finiteness flag, the skip rule, the SGD step, the rolling
mean), idle inside it included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("train.optimizer",), "device_ms", "steps")
