"""Model FLOPs of the traced window's oracle batches (flops.py
infer_batch_flops) over the window and the bf16 peak."""
from benchmark.readers import infer_mfu


def read(run):
    return infer_mfu(run)
