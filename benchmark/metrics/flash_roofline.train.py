"""Kernel 1 in the frozen trunk's forward of a training step: the
attention's least time at its shapes (flops.py flash_bound_s) over the
profiler's device time of the kernels that ran it. Nothing when none ran."""
from benchmark import flops
from benchmark.readers import roofline_share

KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_kernel", "flash_fwd_f32_kernel")


def read(run):
    return roofline_share(run, KERNELS, flops.flash_bound_s(
        run.cfg, run.traffic["batch"]) * run.work["steps"])
