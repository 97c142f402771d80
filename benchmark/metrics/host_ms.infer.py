"""Host milliseconds an oracle batch: the eval.batch span (`make_run_fn`'s
call: the model, without the upload and the copy back) on the host
clock."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("eval.batch",), "host_ms", "requests")
