"""A whole run of each cell's driver on the CPU at tiny sizes, the look
for a chip skipped: a sound run is correct, and the timed path broken
underneath makes `correct` false, once for each fault the cell can have.
The cells run on one chip, so no exchange between chips can be left out."""
import pytest
import torch

from benchmark import compare, controls, generator, harness
from benchmark.tests import tiny
from benchmark.traffic import train


def drive(workload, seed=3):
    run = tiny.run(workload, seed=seed)
    harness.load_module("traffic", run.traffic["driver"]).run(run)
    return run


@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_sound_run_is_correct(workload, f32_port):
    run = drive(workload)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("workload", ["dinov2-train-b8", "sam-finetune-b8"])
def test_step_that_returns_its_state_unchanged(workload, f32_port,
                                               monkeypatch):
    from ovmono3d_tpu_torch.train.optim import Optimizer
    monkeypatch.setattr(Optimizer, "step", lambda self, grads, skip=None:
                        None)
    run = drive(workload)
    assert not run.correct
    assert run.checks["delta_gap"][0] == pytest.approx(1.0)
    if "grad_gap" in run.checks:
        assert run.checks["grad_gap"][0] > run.checks["grad_gap"][1]


@pytest.mark.parametrize("workload", ["dinov2-train-b8", "sam-finetune-b8"])
def test_half_the_batch_left_out(workload, f32_port):
    with controls.half_batch():
        run = drive(workload)
    assert not run.correct, run.checks


def test_an_answer_altered_where_it_is_produced(f32_port, monkeypatch):
    from ovmono3d_tpu_torch.models.rcnn3d import RCNN3D
    forward = RCNN3D.forward

    def altered(self, *args, **kwargs):
        det = forward(self, *args, **kwargs)
        det.corners3d[:, 0] += 0.5 * det.corners3d[:, 0].abs().mean()
        return det
    monkeypatch.setattr(RCNN3D, "forward", altered)
    run = drive("dinov2-eval-b8")
    assert not run.correct, run.checks
    assert run.checks["corners_rms_gap"][0] > run.checks["corners_rms_gap"][1]


@pytest.mark.parametrize("workload", ["dinov2-train-b8", "sam-finetune-b8"])
def test_training_control_fails(workload):
    """The reference in float8 (the products the configuration states in
    bfloat16) put in the program's place fails the cell's limits."""
    run = tiny.run(workload, seed=5)
    g = torch.Generator().manual_seed(run.seed)
    pool = [generator.train_batch(g, run.cfg, run.traffic, "cpu")
            for _ in range(train.CHECKED_STEPS)]
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    from benchmark import weights
    model = build_model(run.port().model, device="meta")
    w = weights.draw(weights.specs_of(model), run.seed, "cpu",
                     run.cfg.get("weight_means"))
    ref = train.reference(run, w, pool)
    ctl = train.reference(run, w, pool, mode="fp8")
    nums = compare.train_numbers(ctl, ref)
    limits = run.traffic["limits"]
    assert any(v > limits[k] for k, v in nums.items() if k in limits), nums


def test_oracle_control_fails():
    """The reference in float8 put in the program's place fails the cell's
    limits. (The program's own int8 serving path reads like its bfloat16
    one at these limits, on the card too: it is no lower precision here,
    PERF.md section 2.)"""
    from benchmark.traffic import infer
    run = tiny.run("dinov2-eval-b8", seed=5)
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    from benchmark import weights
    model = build_model(run.port().model, device="meta")
    w = weights.draw(weights.specs_of(model), run.seed, "cpu",
                     run.cfg.get("weight_means"))
    worst = {}
    for batch in infer.host_pool(run, "cpu")[:2]:
        ref = infer.reference(run, w, batch, "cpu")
        ctl = infer.reference(run, w, batch, "cpu", mode="fp8")
        nums = compare.infer_numbers(ctl, ref,
                                     torch.from_numpy(batch["oracle_valid"]))
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    limits = run.traffic["limits"]
    assert any(v > limits[k] for k, v in worst.items() if k in limits), worst


def test_traced_run_reads_its_window(f32_port):
    """With tracing, the window's last seconds run under the profiler and
    the readers find their counts (no device events on the CPU)."""
    run = tiny.run("dinov2-eval-b8", seconds=1.0, trace=True)
    harness.load_module("traffic", run.traffic["driver"]).run(run)
    assert run.traced is not None and run.work["requests"] > 0
    assert run.traced["window_s"] > 0
    assert harness.load_module("metrics", "mfu.infer").read(run) > 0
