"""Host milliseconds an image of the stream's chunk dispatch: the
stream.chunk span (`make_lift_stream_fn`'s run: a chunk's uploads,
canvases, detector, postprocess and lift enqueued) over its images."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("stream.chunk",), "host_ms", "images")
