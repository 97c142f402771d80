"""Device operations per image in the traced training window, from the
profiler: the host launches one step's work op by op, so this counts what
the driver thread dispatches."""
from benchmark.readers import ops_per_image


def read(run):
    return ops_per_image(run)
