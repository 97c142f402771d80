"""Kernel 8 in the Swin trunk of the stream's chunks: its least time
(gdino_flops.py window_bound_s at the chunk's batch, over the traced
chunks) over the device time of the kernels that ran it. Nothing when none
ran."""
from benchmark import gdino_flops
from benchmark.readers import roofline_share

KERNELS = ("window_fwd_sm90_kernel", "window_fwd_kernel")


def read(run):
    if not run.work.get("requests"):
        return None
    return roofline_share(run, KERNELS, gdino_flops.window_bound_s(
        run.cfg, run.traffic["chunk"]) * run.work["requests"])
