"""The plain reference against the port at tiny sizes on the CPU, the
port computing in float32: the same losses, gradients, updates and lifted
corners to rounding."""
import pytest
import torch

from benchmark import compare, generator
from benchmark.tests import tiny
from benchmark.traffic import infer, train


@pytest.mark.parametrize("workload", ["dinov2-train-b8", "sam-finetune-b8"])
def test_three_training_steps(workload, f32_port):
    run = tiny.run(workload, seed=2**31 + 5)
    model, opt, state, step, w = train.build(run, "cpu")
    g = torch.Generator().manual_seed(run.seed)
    pool = [generator.train_batch(g, run.cfg, run.traffic, "cpu")
            for _ in range(3)]
    _, prog = train.first_steps(opt, state, step, pool, w)
    ref = train.reference(run, w, pool)
    assert sorted(prog["grad"]) == sorted(ref["grad"])
    nums = compare.train_numbers(prog, ref)
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-3
    assert nums["delta_gap"] < 1e-3


def test_oracle_forward(f32_port):
    run = tiny.run("dinov2-eval-b8", seed=11)
    fn, w = infer.build(run, "cpu")
    for batch in infer.host_pool(run, "cpu")[:2]:
        out = infer.request(fn, batch, "cpu")
        ref = infer.reference(run, w, batch, "cpu")
        nums = compare.infer_numbers(
            {k: torch.from_numpy(out[k]) for k in ("corners3d", "scores")},
            ref, torch.from_numpy(batch["oracle_valid"]))
        assert nums["corners_gap"] < 1e-4
        assert nums["score_gap"] < 1e-5


def test_generator_is_seeded_and_shaped():
    run = tiny.run("dinov2-train-b8")
    a = generator.train_batch(torch.Generator().manual_seed(5), run.cfg,
                              run.traffic, "cpu")
    b = generator.train_batch(torch.Generator().manual_seed(5), run.cfg,
                              run.traffic, "cpu")
    assert torch.equal(a["image"], b["image"])
    assert a["draws"]["anchor"].shape[-1] == generator.anchor_count(run.cfg)
    hw = a["im_hw"].float()
    boxes = a["gt_boxes"]
    assert bool((boxes[..., 2] > boxes[..., 0]).all())
    assert bool((boxes[..., 2] <= hw[:, None, 1]).all())
    assert bool((boxes[..., 3] <= hw[:, None, 0]).all())
