"""Device milliseconds a training step in the proposals: the model.proposals
span (per-level top-k, decode, the NMS fixpoint, proposal sampling), idle
inside it included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("model.proposals",), "device_ms", "steps")
