"""The idle-share, roofline and percentile arithmetic on a synthetic
trace."""
import numpy as np
import pytest

from benchmark import harness, readers


def synthetic():
    """Device busy [0, 100] us, [50, 150] (overlapping kernels), idle
    150..400, busy [400, 500]; a 1000 us window. Events as
    harness.trace_events gives them: (name, on the device, start, end)."""
    return [("void flash_fwd_sm90_kernel<false>", True, 0.0, 100.0),
            ("gemm", True, 50.0, 150.0),
            ("void flash_fwd_sm90_kernel<false>", True, 400.0, 500.0),
            ("cudaLaunchKernel", False, 45.0, 55.0),
            ("cudaDeviceSynchronize", False, 140.0, 420.0),
            ("cudaStreamSynchronize", False, 200.0, 300.0)]


def test_busy_gaps_and_owners():
    t = harness.reduce_trace(synthetic(), 1000e-6)
    assert t["busy_s"] == pytest.approx(250e-6)
    assert t["device_ops"] == 3
    assert t["kernels"]["void flash_fwd_sm90_kernel<false>"] == \
        pytest.approx(200e-6)
    # The shortest CUDA call open across the gap, and what ended it.
    assert t["idle_gaps"] == [[
        "cudaStreamSynchronize before flash_fwd_sm90_kernel<false>",
        pytest.approx(250e-6)]]
    assert t["top_ops"] == [["flash_fwd_sm90_kernel<false>",
                             pytest.approx(200e-6)],
                            ["gemm", pytest.approx(100e-6)]]


def test_a_gap_with_no_cuda_call_is_host_dispatch():
    events = [e for e in synthetic() if "Synchronize" not in e[0]]
    t = harness.reduce_trace(events, 1000e-6)
    assert t["idle_gaps"][0][0] == \
        "no CUDA call before flash_fwd_sm90_kernel<false>"


def test_idle_and_roofline_readers():
    run = harness.Run(workload="w", cfg={}, traffic={"batch": 8}, seed=0,
                      seconds=1, trace=True)
    run.traced = harness.reduce_trace(synthetic(), 1000e-6)
    run.work = {"images": 8, "steps": 1}
    assert readers.idle_percent(run) == pytest.approx(75.0)
    assert readers.ops_per_image(run) == pytest.approx(3 / 8)
    assert readers.roofline_share(run, ("flash_fwd_sm90_kernel",),
                                  50e-6) == pytest.approx(25.0)
    assert readers.roofline_share(run, ("relpos_bwd_dq_kernel",), 1.0) \
        is None
    run.traced = None
    assert readers.idle_percent(run) is None


def test_p95_is_the_tail_of_all_requests():
    lat = list(np.linspace(0.010, 0.029, 20)) + [0.2]
    assert np.percentile(lat, 95) == pytest.approx(0.029)
