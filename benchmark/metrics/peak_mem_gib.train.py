"""The run's peak of allocated device memory
(torch.cuda.max_memory_allocated), GiB."""
from benchmark.readers import peak_gib


def read(run):
    return peak_gib(run)
