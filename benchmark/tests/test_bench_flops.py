"""flops.py's analytic counts against torch's FlopCounterMode over the
plain reference at small sizes (FlopCounterMode counts products and
convolutions; the element-wise bias adds and ROIAlign's taps it does not
see are taken out of the analytic side)."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.reference import model as M
from benchmark.reference.numerics import Ops
from benchmark.tests import tiny


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def params_of(cfg):
    """Seeded weights in the reference's layout, from the port's names."""
    from benchmark import harness, weights
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    model = build_model(harness.port_config(cfg).model, device="meta")
    return weights.draw(weights.specs_of(model), 3, "cpu",
                        cfg.get("weight_means"))


@pytest.mark.parametrize("name", ["lift-dinov2-vitb14", "lift-sam-vitb16"])
def test_trunk_and_pyramid(name):
    cfg = tiny.config(name)
    p = params_of(cfg)
    side = cfg["model"]["backbone"]["square_pad"]
    x = torch.randn(2, 3, side, side)
    with torch.no_grad():
        got = counted(lambda: M.trunk(Ops(), p, cfg, x))
        adds = sum(2.0 * c["b"] * c["h"] * c["n"] ** 2
                   for c in flops.attention_calls(cfg, 2) if c["grid"])
        assert got == flops.trunk_flops(cfg, 2) - adds
        feat = M.trunk(Ops(), p, cfg, x)
        assert counted(lambda: M.pyramid(Ops(), p, cfg, feat)) == \
            flops.pyramid_flops(cfg, 2)


def test_heads():
    cfg = tiny.config("lift-dinov2-vitb14")
    p = params_of(cfg)
    c = cfg["model"]["backbone"]["out_channels"]
    pooled = torch.randn(10, 7, 7, c)
    taps = 10 * 8.0 * 2 * 2 * 7 * 7 * c
    with torch.no_grad():
        assert counted(lambda: M.box_head(p, pooled, 2)) == \
            flops.roi_flops(cfg, 10, "box") - taps
        assert counted(lambda: M.cube_head(p, pooled, 2)) == \
            flops.roi_flops(cfg, 10, "cube") - taps


def test_backward_counts_twice_the_forward():
    """A product whose input and weight both take gradients costs twice
    its forward backward, the rule train_step_flops applies."""
    x = torch.randn(64, 32, requires_grad=True)
    w = torch.randn(16, 32, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        y = torch.nn.functional.linear(x, w)
        fwd = fc.get_total_flops()
        y.sum().backward()
    assert fc.get_total_flops() == 3 * fwd


def test_step_and_bounds_at_the_cells_sizes():
    from benchmark import harness
    dino = harness.read_json("configs", "lift-dinov2-vitb14")
    sam = harness.read_json("configs", "lift-sam-vitb16")
    geo = flops.trunk_geometry(dino)
    assert (geo["grid"], geo["tokens"]) == (64, 4097)
    geo = flops.trunk_geometry(sam)
    assert (geo["grid"], geo["tokens"], geo["windows"]) == (64, 4096, 25)
    # Kernel 1 at [8, 4097, 12, 64] is bound by its operations: 0.417 ms.
    one = flops.flash_bound_s(dino, 8) / 12
    assert one == pytest.approx(4 * 8 * 12 * 4097 ** 2 * 64 / 989e12)
    assert flops.train_step_flops(sam, 8) == pytest.approx(
        3 * (flops.trunk_flops(sam, 8) + flops.pyramid_flops(sam, 8)
             + flops.rpn_flops(sam, 8) + flops.roi_flops(sam, 4096, "box")
             + flops.roi_flops(sam, 4096, "cube")))
