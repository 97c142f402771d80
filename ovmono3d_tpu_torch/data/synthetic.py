"""Generated evaluation data, for running the evaluation path without a
dataset on disk: copies of tools/train_net.py `synthetic_records` and of the
synthetic branch of tools/eval_net.py's main."""
from __future__ import annotations

import numpy as np


def synthetic_records(num: int, num_classes: int, seed: int = 0):
    """Generated Omni3D-style records with plausible cuboids: 640 x 480
    images, f = 500, 1-4 axis-aligned boxes each, 2D boxes their projected
    fronts."""
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(num):
        h, w = 480, 640
        f = 500.0
        annos = []
        for _ in range(rng.randint(1, 5)):
            z = rng.uniform(1.5, 8.0)
            dims = rng.uniform(0.2, 1.5, 3).tolist()
            x = rng.uniform(-0.8, 0.8) * z * 0.5
            y = rng.uniform(-0.5, 0.5) * z * 0.5
            u = f * x / z + w / 2
            v = f * y / z + h / 2
            bw = f * dims[2] / z
            bh = f * dims[1] / z
            annos.append({
                "category_id": int(rng.randint(num_classes)),
                "category": str(int(rng.randint(num_classes))),
                "bbox2d": [u - bw / 2, v - bh / 2, u + bw / 2, v + bh / 2],
                "center_cam": [x, y, z],
                "dimensions": dims,
                "pose": np.eye(3).tolist(),
                "ignore": False,
            })
        recs.append({
            "file_name": f"synthetic_{i}.jpg",
            "image_id": i,
            "width": w,
            "height": h,
            "K": [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
            "dataset_id": 0,
            "annotations": annos,
        })
    return recs


SYNTHETIC_DATASETS = (("synthetic_a", 7), ("synthetic_b", 11))


def synthetic_datasets(num_classes: int, class_names: list[str],
                       num: int = 16, oracle: bool = True
                       ) -> tuple[dict[str, list[dict]], set[str]]:
    """The JAX eval CLI's `--synthetic` data: two datasets of `num` records
    (seeds 7 and 11, so the cross-dataset merge runs), each record's oracle
    slots its GT boxes with score 1 (the GT-oracle protocol; `oracle=False`
    leaves them out, for the learned-2D branch), and half the classes taken
    as novel. Returns ({name: records}, novel category names)."""
    datasets = {}
    for name, seed in SYNTHETIC_DATASETS:
        records = synthetic_records(num, num_classes, seed=seed)
        if oracle:
            for rec in records:
                rec["oracle2d"] = [
                    {"bbox2d": a["bbox2d"], "category_id": a["category_id"],
                     "score": 1.0}
                    for a in rec["annotations"] if a["category_id"] >= 0]
        datasets[name] = records
    return datasets, set(class_names[:num_classes // 2])
