"""Host milliseconds a training step: the train.step span (the port's
`train_step` call, from entry to return) on the host clock. Against the
step's device time it says how far dispatch keeps up."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("train.step",), "host_ms", "steps")
