"""The arithmetic the per-layer readers share, over a run's traced window
(harness.reduce_trace) and its count of work. Each returns None when the
trace holds nothing to read, and the harness then leaves the metric out."""
from __future__ import annotations

from benchmark import flops, harness


def ops_per_image(run):
    if not run.traced or not run.work.get("images"):
        return None
    return run.traced["device_ops"] / run.work["images"]


def idle_percent(run):
    if not run.traced or run.traced["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.traced["busy_s"] / run.traced["window_s"])


def peak_gib(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None


def train_mfu(run):
    if not run.traced or not run.work.get("steps"):
        return None
    work = flops.train_step_flops(run.cfg, run.traffic["batch"])
    return 100.0 * work * run.work["steps"] / (
        run.traced["window_s"] * flops.BF16_PEAK)


def infer_mfu(run):
    if not run.traced or not run.work.get("requests"):
        return None
    work = flops.infer_batch_flops(run.cfg, run.traffic["batch"],
                                   run.traffic["oracle_slots"])
    return 100.0 * work * run.work["requests"] / (
        run.traced["window_s"] * flops.BF16_PEAK)


def roofline_share(run, kernels: tuple[str, ...], bound_s: float):
    """bound_s over the device seconds of the traced kernels named by
    `kernels`; None when none of them ran."""
    spent = harness.kernel_seconds(run, kernels)
    if spent <= 0:
        return None
    return 100.0 * bound_s / spent
