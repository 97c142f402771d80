"""Model FLOPs of the traced window's training steps (flops.py
train_step_flops) over the window and the bf16 peak."""
from benchmark.readers import train_mfu


def read(run):
    return train_mfu(run)
