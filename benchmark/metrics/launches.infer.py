"""Device operations per image in the traced evaluation window, from the
profiler (uploads and copies back included)."""
from benchmark.readers import ops_per_image


def read(run):
    return ops_per_image(run)
