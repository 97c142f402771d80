"""The numbers that decide `correct`, from the program's and the
reference's readings of the same inputs. A cell's traffic file names the
numbers it holds to a limit (`limits`); the others are printed beside them.

Training (three steps from the same weights on the same batches and
draws):
- `grad_gap`: over the trainable leaves, the largest gap between the
  program's and the reference's norm of the first step's gradient, over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger (some gradients are all but zero);
- `delta_gap`: the same for each leaf's change over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone);
- `rpn_loss_gap`: the largest relative gap of a step's RPN losses,
  `rpn_grad_diff`: the norm of the difference of the RPN head's first
  gradients over the reference's norm, and `rpn_delta_diff` the same for
  its change over the three steps. Anchor labels and their sampling
  depend on the GT and the draws alone, so these read the trunk's and
  the pyramid's numerics without the proposal sampling's choices, which
  differ between any two precisions;
- `loss_gap` (each step's total loss) and, in `train_diagnostics`, each
  loss's gap and the median leaf's gaps: what the look at the numbers
  read (PERF.md section 2).
Oracle inference (each image's valid boxes):
- `corners_rms_gap`: the root mean square of the corner gaps over that of
  the reference's corners;
- `score_gap`: the largest gap of a fused score;
- `corners_gap`: the largest corner gap over the same scale.
"""
from __future__ import annotations

import statistics

import torch


def _leaf_gaps(prog: dict, ref: dict, names: list[str]) -> float:
    norms_r = {n: float(ref[n].float().norm()) for n in names}
    median = statistics.median(norms_r.values()) if norms_r else 0.0
    worst = 0.0
    for n in names:
        gap = abs(float(prog[n].float().norm()) - norms_r[n])
        worst = max(worst, gap / max(norms_r[n], median, 1e-30))
    return worst


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: {"loss": [a step's total], "losses": [a step's {name:
    loss}], "grad": {leaf: tensor}, "delta": {leaf: tensor}}."""
    names = sorted(ref["grad"])
    gnorm = {n: float(ref["grad"][n].norm()) for n in names}
    median = statistics.median(gnorm.values())
    moving = [n for n in names if gnorm[n] >= 1e-3 * median]
    rpn = [n for n in names if n.startswith("rpn_head.")]

    def rpn_loss(losses):
        return sum(v for k, v in losses.items() if k.startswith("rpn/"))
    return {
        "loss_gap": max(_rel(a, b) for a, b in zip(prog["loss"],
                                                   ref["loss"])),
        "grad_gap": _leaf_gaps(prog["grad"], ref["grad"], names),
        "delta_gap": _leaf_gaps(prog["delta"], ref["delta"], moving),
        "rpn_loss_gap": max(_rel(rpn_loss(a), rpn_loss(b)) for a, b in
                            zip(prog["losses"], ref["losses"])),
        "rpn_grad_diff": _diff(prog["grad"], ref["grad"], rpn),
        "rpn_delta_diff": _diff(prog["delta"], ref["delta"], rpn),
    }


def _diff(prog: dict, ref: dict, names: list[str]) -> float:
    """The norm of the difference over the norm of the reference, over the
    leaves `names` together."""
    num = sum(float((prog[n].float() - ref[n].float()).square().sum())
              for n in names)
    den = sum(float(ref[n].float().square().sum()) for n in names)
    return (num / max(den, 1e-30)) ** 0.5


def train_diagnostics(prog: dict, ref: dict) -> dict:
    """Each loss's largest relative gap over the steps, and the median
    leaf's gradient and change gaps (what the look at a gap reads)."""
    out = {}
    for k in ref["losses"][0]:
        out[k] = max(_rel(a[k], b[k]) for a, b in zip(prog["losses"],
                                                      ref["losses"]))
    for key in ("grad", "delta"):
        norms = {n: float(v.norm()) for n, v in ref[key].items()}
        med = statistics.median(norms.values())
        gaps = [abs(float(prog[key][n].norm()) - norms[n]) / max(norms[n],
                                                                 med)
                for n in norms]
        out[f"median_{key}_gap"] = statistics.median(gaps)
    return out


def infer_numbers(prog: dict, ref: dict, valid: torch.Tensor) -> dict:
    """prog / ref: {"corners3d": [B, N, 8, 3], "scores": [B, N]} in the
    original frame; valid [B, N]."""
    worst_c, worst_s, worst_rms = 0.0, 0.0, 0.0
    for b in range(valid.shape[0]):
        v = valid[b]
        if not bool(v.any()):
            continue
        cr = ref["corners3d"][b][v].float()
        cp = prog["corners3d"][b][v.to(prog["corners3d"].device)].float(
        ).to(cr.device)
        rms = max(float(cr.square().mean().sqrt()), 1e-30)
        worst_c = max(worst_c, float((cp - cr).abs().max()) / rms)
        worst_rms = max(worst_rms,
                        float((cp - cr).square().mean().sqrt()) / rms)
        sr = ref["scores"][b][v].float()
        sp = prog["scores"][b][v.to(prog["scores"].device)].float().to(
            sr.device)
        worst_s = max(worst_s, float((sp - sr).abs().max()))
    return {"corners_gap": worst_c, "score_gap": worst_s,
            "corners_rms_gap": worst_rms}
