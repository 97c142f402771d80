"""Multi-dataset evaluation aggregation + novel-split rollups.

A copy of ovmono3d_tpu/evaluation/helper.py over the port's evaluator; its
evaluators compute their IoU on `device` (CUDA unless the caller asks for
the CPU).

Re-design of Omni3DEvaluationHelper (omni3d_evaluation.py:193-624): per
dataset, 2D + 3D evaluators accumulate; `summarize_all` re-accumulates the
concatenated per-(category, depth-band) image evals across datasets (the
reference's evals_per_cat_area caching), produces Omni3D rollups, the fixed
novel easy/hard category split (L602-613), and mean + disentangled NHD
(computed by the evaluators on IoU-matched pairs,
omni3d_evaluation.py:2370-2426).
"""
from __future__ import annotations

import numpy as np

from ovmono3d_tpu_torch.data.builtin import get_omni3d_categories
from ovmono3d_tpu_torch.evaluation.omni3d_eval import Omni3DEvaluator

# The reference's fixed split over the 22 novel categories
# (omni3d_evaluation.py:602-604).
EASY_NOVEL_CATEGORIES = frozenset(
    {"board", "printer", "painting", "microwave", "tray", "podium", "cart",
     "tram"}
)


class Omni3DEvaluationHelper:
    """Accumulate per-dataset evaluators; summarize per dataset and overall."""

    def __init__(self, num_classes: int, class_names: list[str],
                 base_categories: set[str] | None = None,
                 novel_categories: set[str] | None = None, device=None):
        self.num_classes = num_classes
        self.device = device            # the evaluators' IoU device
        self.class_names = class_names
        self.base_categories = set(base_categories or [])
        self.novel_categories = set(novel_categories or [])
        self.ev2d: dict[str, Omni3DEvaluator] = {}
        self.ev3d: dict[str, Omni3DEvaluator] = {}

    def evaluator(self, dataset: str, mode: str,
                  eval_prox: bool = False) -> Omni3DEvaluator:
        """Get-or-create the per-dataset evaluator. `eval_prox` applies on
        creation only (proximity evaluation for non-exhaustively annotated
        datasets, reference omni3d_evaluation.py:263)."""
        store = self.ev2d if mode == "2D" else self.ev3d
        if dataset not in store:
            store[dataset] = Omni3DEvaluator(
                self.num_classes, mode, self.class_names,
                eval_prox=eval_prox, device=self.device,
            )
        return store[dataset]

    def add_image(self, dataset: str, gt: dict, pred: dict,
                  eval_prox: bool = False):
        self.evaluator(dataset, "2D", eval_prox).add_image(gt, pred)
        self.evaluator(dataset, "3D", eval_prox).add_image(gt, pred)

    def summarize_dataset(self, dataset: str) -> dict[str, float]:
        out = {}
        if dataset in self.ev2d:
            out.update(self.ev2d[dataset].summarize())
        if dataset in self.ev3d:
            out.update(self.ev3d[dataset].summarize())
        return out

    def _merged(self, mode: str) -> Omni3DEvaluator:
        """Concatenate per-(cat, band) evals across datasets
        (evals_per_cat_area re-accumulation, omni3d_evaluation.py:427-620)."""
        merged = Omni3DEvaluator(self.num_classes, mode, self.class_names,
                                 device=self.device)
        store = self.ev2d if mode == "2D" else self.ev3d
        for ev in store.values():
            for band in merged.evals:
                for c in range(self.num_classes):
                    merged.evals[band][c].extend(ev.evals[band][c])
            if mode == "3D":
                merged._nhd_values.extend(ev._nhd_values)
                for k in merged._nhd_dis:
                    merged._nhd_dis[k].extend(ev._nhd_dis[k])
                for k in merged._errors:
                    merged._errors[k].extend(ev._errors[k])
        return merged

    def summarize_all(self) -> dict[str, object]:
        out: dict[str, object] = {"datasets": {}}
        for name in sorted(set(self.ev2d) | set(self.ev3d)):
            out["datasets"][name] = self.summarize_dataset(name)

        merged2d = self._merged("2D")
        merged3d = self._merged("3D")
        overall = {**merged2d.summarize(), **merged3d.summarize()}
        out["overall"] = overall
        per_cat = merged3d.per_category_ap()
        out["per_category_AP3D"] = per_cat
        out["per_category_AP2D"] = merged2d.per_category_ap()
        out["per_category_AR2D"] = merged2d.per_category_ar()
        out["per_category_AR3D"] = merged3d.per_category_ar()
        # Category-mean rollups — the reference's general_2D/3D_AP/AR
        # (mean of the per-category values, omni3d_evaluation.py:521-531),
        # a different aggregation than the joint mean in `overall`.
        # Documented deviation: the reference averages over ALL declared
        # categories, so one declared-but-dataless category poisons the
        # whole rollup to NaN; we average the categories WITH data (equal
        # on real Omni3D sets, where every declared category has GT).
        for key, table in (
            ("general_AP2D", out["per_category_AP2D"]),
            ("general_AR2D", out["per_category_AR2D"]),
            ("general_AP3D", per_cat),
            ("general_AR3D", out["per_category_AR3D"]),
        ):
            if table:
                out[key] = float(np.mean(list(table.values())))

        # Omni3D In/Out rollups over the indoor/outdoor category universes
        # (reference omni3d_evaluation.py:427-620 analysis tables).
        for roll, key in (("omni3d_in", "AP3D_omni_in"),
                          ("omni3d_out", "AP3D_omni_out")):
            cats = get_omni3d_categories(roll)
            # The reference reports the rollup ONLY when every category of
            # the set was evaluated (len(set - categories) == 0, else NaN,
            # omni3d_evaluation.py:553/567) — a partial mean would look
            # comparable to published Omni3D_In/Out numbers but cover a
            # different category set.
            if cats.issubset(per_cat.keys()):
                out[key] = float(np.mean([per_cat[c] for c in cats]))

        # Novel easy/hard split (fixed category lists, L602-613; the
        # reference gates on the full 22-novel-category set — we allow
        # subsets but both splits are restricted to the declared NOVEL
        # categories so base-category APs can never leak in).
        if self.novel_categories:
            easy = {
                c: ap for c, ap in per_cat.items()
                if c in EASY_NOVEL_CATEGORIES and c in self.novel_categories
            }
            hard = {
                c: ap for c, ap in per_cat.items()
                if c in self.novel_categories and c not in
                EASY_NOVEL_CATEGORIES
            }
            if easy:
                out["novel_easy_AP3D"] = float(np.mean(list(easy.values())))
            if hard:
                out["novel_hard_AP3D"] = float(np.mean(list(hard.values())))

        for k, vals in merged3d._nhd_dis.items():
            if vals:
                out[f"NHD_disentangled_{k}"] = float(np.mean(vals))
        for k, vals in merged3d._errors.items():
            if vals:
                out[f"mean_err_{k}"] = float(np.mean(vals))
        return out
