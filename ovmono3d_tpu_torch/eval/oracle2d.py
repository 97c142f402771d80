"""Oracle-2D detection JSONs from the open-vocabulary GroundingDINO
(counterpart of tools/generate_oracle2d.py).

The reference's evaluation reads precomputed GroundingDINO detections per
test dataset (`datasets.oracle2d_files[eval_mode][cat_mode][dataset]`,
merged into the records by `data.datasets.merge_oracle2d`). This sweeps the
port's GroundingDINO over each configured test dataset with
`detect_2d_stream` and writes them:

    python -m ovmono3d_tpu_torch.eval.oracle2d --synthetic [--device cpu]
    python -m ovmono3d_tpu_torch.eval.oracle2d --config-file configs/... \
        --output-dir out/oracle2d [key=value ...]
    python -m ovmono3d_tpu_torch.eval.cli --config-file configs/... \
        "datasets.oracle2d_files.target_aware.novel.<ds>=<the file>"

The prompt follows `datasets.oracle2d_eval_mode`: target_aware prompts with
the dataset's own categories (its novel split under `test.cat_mode=novel`,
else the categories annotated in it), previous_metric with every configured
category. Each dataset's file is a JSON list of {"image_id", "bbox2d"
[x1, y1, x2, y2] pixels, "category_id" (the model's contiguous id),
"score"}. `--synthetic` runs two generated datasets of random images.
GroundingDINO's weights are drawn from a seed unless `--gdino-ckpt` names the
released groundingdino_swinb_cogcoor.pth (the original repo's keys,
`utils/gdino_convert.py`); the tokenizer reads BERT's vocab.txt from
`--vocab`, else its vocabulary is made of the category words (as
tools/generate_oracle2d.py). Runs on CUDA unless `--device` names another
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np

from ovmono3d_tpu_torch.config import load_config
from ovmono3d_tpu_torch.data.build import default_image_loader
from ovmono3d_tpu_torch.data.builtin import get_omni3d_categories
from ovmono3d_tpu_torch.data.datasets import (filter_settings_from_cfg,
                                              get_dataset, simple_register)
from ovmono3d_tpu_torch.data.synthetic import synthetic_records
from ovmono3d_tpu_torch.models.gdino.tokenizer import BertTokenizer
from ovmono3d_tpu_torch.models.ovmono3d import OVMono3DLift
from ovmono3d_tpu_torch.utils.load import load_gdino_params

logger = logging.getLogger("ovmono3d.oracle2d")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="two generated datasets of random images")
    ap.add_argument("--output-dir", default="output/oracle2d")
    ap.add_argument("--score-threshold", type=float, default=0.0,
                    help="drop detections below this score (the detector "
                         "already applies the reference's box threshold)")
    ap.add_argument("--topk", type=int, default=100,
                    help="at most this many detections an image")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (e.g. cpu)")
    ap.add_argument("--gdino-ckpt", default=None,
                    help="the released GroundingDINO SwinB checkpoint "
                         "(groundingdino_swinb_cogcoor.pth)")
    ap.add_argument("--vocab", default=None,
                    help="BERT's vocab.txt (bert-base-uncased)")
    ap.add_argument("opts", nargs="*", default=[])
    return ap.parse_args(argv)


def dataset_prompts(cfg, name: str, records: list[dict],
                    class_names: list[str]) -> list[str]:
    """The category prompt of one test dataset, by the eval mode."""
    if cfg.datasets.oracle2d_eval_mode == "previous_metric":
        return list(class_names)
    if cfg.test.cat_mode == "novel":
        try:
            return sorted(get_omni3d_categories(name))
        except ValueError:
            pass
    present = sorted({a["category_id"] for r in records
                      for a in r.get("annotations", [])
                      if a["category_id"] >= 0})
    return [class_names[c] for c in present if c < len(class_names)]


def category_tokenizer(class_names: list[str]) -> BertTokenizer:
    """A tokenizer whose vocabulary is BERT's special tokens and the
    category names' words (tools/generate_oracle2d.py's without --vocab)."""
    words = sorted({w for c in class_names for w in c.lower().split()})
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, ".": 4}
    vocab.update({w: 5 + i for i, w in enumerate(words)})
    return BertTokenizer(vocab)


def random_image(rec: dict) -> np.ndarray:
    """The synthetic datasets' image of a record: uniform noise seeded by
    its image_id (tools/generate_oracle2d.py's)."""
    rng = np.random.RandomState(rec["image_id"] % (2 ** 31))
    return (rng.rand(rec["height"], rec["width"], 3) * 255).astype(np.uint8)


def generate_for_dataset(pipe: OVMono3DLift, records: list[dict],
                         image_loader, prompts: list[str],
                         cat_map: dict[str, int], score_threshold: float,
                         dataset_name: str) -> list[dict]:
    """The dataset's detections through `pipe.detect_2d_stream`, in the
    file's schema: the valid slots at or above `score_threshold` whose
    prompt is a model category. `image_loader` None: `random_image`."""
    load = image_loader or random_image
    out = []
    t0 = t_mark = time.perf_counter()
    stream = pipe.detect_2d_stream((load(r) for r in records), prompts)
    for i, (rec, det) in enumerate(zip(records, stream)):
        for j in np.flatnonzero(det["valid"]):
            score = float(det["scores"][j])
            name = prompts[int(det["classes"][j])]
            if score < score_threshold or name not in cat_map:
                continue
            out.append({"image_id": rec["image_id"],
                        "bbox2d": [float(v) for v in det["boxes"][j]],
                        "category_id": cat_map[name], "score": score})
        if time.perf_counter() - t_mark > 10.0:
            per = (time.perf_counter() - t0) / (i + 1)
            logger.info("%s: %d/%d images, %.3f s an image", dataset_name,
                        i + 1, len(records), per)
            t_mark = time.perf_counter()
    return out


def main(argv=None) -> dict[str, Path]:
    """Write each dataset's detections; returns {dataset: path}."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config_file, overrides=args.opts)
    class_names = list(cfg.datasets.category_names) or [
        str(i) for i in range(cfg.model.num_classes)]
    cat_map = {n: i for i, n in enumerate(class_names)}
    if args.synthetic:
        datasets = {name: synthetic_records(4, cfg.model.num_classes,
                                            seed=seed)
                    for name, seed in (("synthetic_a", 7),
                                       ("synthetic_b", 11))}
        image_loader = None
    else:
        fs = filter_settings_from_cfg(cfg)
        names = (cfg.datasets.test_novel if cfg.test.cat_mode == "novel"
                 else cfg.datasets.test_base)
        datasets = {}
        for name in names:
            simple_register(name, Path(cfg.datasets.data_root) / "Omni3D"
                            / f"{name}.json", fs, cat_map)
            datasets[name] = get_dataset(name)
        image_loader = default_image_loader(cfg.datasets.data_root)
    if args.vocab:
        tok = BertTokenizer(args.vocab)
    else:
        tok = category_tokenizer(class_names)
        logger.warning("no --vocab: a vocabulary of the category words")
    pipe = OVMono3DLift.build_2d_only(tok, device=args.device)
    pipe = dataclasses.replace(pipe, detect_topk=args.topk)
    if args.gdino_ckpt:
        load_gdino_params(pipe.gdino, args.gdino_ckpt)
        logger.info("loaded %s", args.gdino_ckpt)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    eval_mode, cat_mode = cfg.datasets.oracle2d_eval_mode, cfg.test.cat_mode
    paths = {}
    for name, records in datasets.items():
        prompts = dataset_prompts(cfg, name, records, class_names)
        logger.info("%s: %d images, %d category prompts", name, len(records),
                    len(prompts))
        dets = generate_for_dataset(pipe, records, image_loader, prompts,
                                    cat_map, args.score_threshold, name)
        path = paths[name] = out_dir / f"{name}_{cat_mode}.json"
        with open(path, "w") as fh:
            json.dump(dets, fh)
        logger.info("%s: wrote %d detections -> %s", name, len(dets), path)
        print(f"datasets.oracle2d_files.{eval_mode}.{cat_mode}.{name}={path}")
    return paths


if __name__ == "__main__":
    main()
