"""Kernel 1 in the trunk of an oracle-2D batch: the attention's least time
(flops.py flash_bound_s) over the device time of the kernels that ran it.
Nothing when none ran."""
from benchmark import flops
from benchmark.readers import roofline_share

KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_kernel", "flash_fwd_f32_kernel")


def read(run):
    return roofline_share(run, KERNELS, flops.flash_bound_s(
        run.cfg, run.traffic["batch"]) * run.work["requests"])
