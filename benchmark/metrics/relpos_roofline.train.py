"""Kernel 7's log-sum-exp instance and the rel-pos backward in a SAM
training step: their least time (flops.py relpos_train_bound_s) over the
device time of the kernels that ran them. Nothing when none ran."""
from benchmark import flops
from benchmark.readers import roofline_share

KERNELS = ("relpos_fwd_sm90_kernel", "relpos_bwd_stats_kernel",
           "relpos_bwd_dkdv_kernel", "relpos_bwd_dq_kernel")


def read(run):
    return roofline_share(run, KERNELS, flops.relpos_train_bound_s(
        run.cfg, run.traffic["batch"]) * run.work["steps"])
