"""The port's train CLI (`python -m ovmono3d_tpu_torch.train.cli`) on the
CPU, mirroring the JAX package's train CLI tests (tests/test_cli.py and
tests/test_cli_real_loader.py:60): the priors and the cluster decode with
the in-train evaluation; training and then evaluating the checkpoint with
priors.npz found beside it; --resume; --eval-only; the refusals; priors.npz
equal to the JAX package's compute_priors on the same records; training on
the tiny Omni3D fixture through the real loader, then the offline
evaluation of the dumped predictions.
"""
import json
import logging
import re

import numpy as np
import pytest
import torch
from fixtures.tiny_omni3d import CATEGORY_NAMES, build_dataset

from ovmono3d_tpu import config as jcfg
from ovmono3d_tpu.utils.priors import compute_priors as jax_compute_priors
from ovmono3d_tpu_torch.eval import cli as eval_cli
from ovmono3d_tpu_torch.eval import predictions
from ovmono3d_tpu_torch.train import cli
from test_torch_trunks import (assert_trunk_equal, jax_init_tree,  # noqa: F401
                               tiny_presets, trunk_state)
from tools.train_net import synthetic_records as jax_synthetic_records

torch.set_num_threads(2)

# tests/test_cli.py's tiny model.
TINY = [
    "model.backbone.embed_dim=64", "model.backbone.depth=2",
    "model.backbone.num_heads=2", "model.backbone.pretrain_grid=8",
    "model.backbone.out_channels=64", "model.backbone.square_pad=112",
    "model.roi_box.fc_dim=64", "model.roi_box.batch_size_per_image=32",
    "model.rpn.pre_nms_topk_train=128", "model.rpn.post_nms_topk_train=128",
    "model.rpn.pre_nms_topk_test=128", "model.rpn.post_nms_topk_test=64",
    "model.rpn.batch_size_per_image=64", "model.cube.fc_dim=64",
    "model.num_classes=9", "model.max_detections=16",
]
CLUSTER = ["model.cube.dims_priors_enabled=true", "model.cube.cluster_bins=4"]
CPU = ["--device", "cpu"]


def test_priors_cluster_decode_and_in_train_eval(tmp_path, caplog):
    with caplog.at_level(logging.INFO):
        res = cli.main(["--synthetic", *CPU, "--max-iter", "2",
                        "--batch-size", "8", *TINY, *CLUSTER,
                        "test.eval_period=2", "solver.checkpoint_period=1000",
                        f"output_dir={tmp_path}"])
    assert any("in-train eval @ iter 2" in r.getMessage()
               for r in caplog.records)
    assert res["step"] == 2 and res["skipped"] == 0
    assert len(res["evals"]) == 1
    assert res["evals"][0]["AP2D"] == 100.0     # GT boxes as the oracle
    assert (tmp_path / "priors.npz").exists()
    for name in ("model_final.pt", "metrics.jsonl"):
        assert (tmp_path / name).exists()
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))


def test_priors_equal_jax_compute_priors(tmp_path):
    cli.main(["--synthetic", *CPU, "--max-iter", "1", "--batch-size", "2",
              "--no-tensorboard", *TINY, *CLUSTER, "test.eval_period=0",
              f"output_dir={tmp_path}"])
    got = np.load(tmp_path / "priors.npz")
    cfg = jcfg.load_config(None, overrides=[*TINY, *CLUSTER])
    cube = cfg.model.cube
    want = jax_compute_priors(      # as tools/train_net.py calls it
        jax_synthetic_records(256, cfg.model.num_classes),
        cfg.model.num_classes, cube.cluster_bins,
        virtual_depth=cube.virtual_depth, virtual_focal=cube.virtual_focal,
        test_min=cfg.input.min_size_test, test_max=cfg.input.max_size_test,
        anchor_min=cfg.model.anchors.sizes[0][0],
        anchor_max=cfg.model.anchors.sizes[-1][-1])
    assert set(got.files) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_train_then_eval_checkpoint_with_priors(tmp_path, capsys):
    cli.main(["--synthetic", *CPU, "--max-iter", "2", "--batch-size", "8",
              *TINY, *CLUSTER, "test.eval_period=0",
              "solver.checkpoint_period=2", f"output_dir={tmp_path}"])
    assert (tmp_path / "model_recent.pt").exists()
    assert (tmp_path / "priors.npz").exists()
    capsys.readouterr()
    eval_cli.main(["--synthetic", *CPU, "--batch-size", "8", "--checkpoint",
                   str(tmp_path / "model_recent.pt"), *TINY, *CLUSTER])
    assert "overall (all test datasets merged)" in capsys.readouterr().out


def test_resume(tmp_path, caplog):
    base = ["--synthetic", *CPU, "--batch-size", "8", *TINY,
            "test.eval_period=0", "solver.checkpoint_period=2",
            f"output_dir={tmp_path}"]
    assert cli.main([*base, "--max-iter", "2"])["step"] == 2
    with caplog.at_level(logging.INFO):
        res = cli.main([*base, "--max-iter", "4", "--resume"])
    assert any("resumed from" in r.getMessage() and "at step 2" in
               r.getMessage() for r in caplog.records)
    assert res["step"] == 4
    steps = [json.loads(line)["step"] for line in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert steps[-1] == 4


def test_eval_only_delegates(tmp_path, capsys):
    cli.main(["--eval-only", "--synthetic", *CPU, *TINY,
              f"output_dir={tmp_path}"])
    assert "overall (all test datasets merged)" in capsys.readouterr().out
    assert cli.eval_only_argv(cli.parse_args(
        ["--eval-only", "--config-file", "c.yaml", "--checkpoint", "m.pt",
         "--batch-size", "4", "--device", "cpu", "a=1"])) == [
        "--config-file", "c.yaml", "--checkpoint", "m.pt", "--batch-size",
        "4", "--device", "cpu", "a=1"]


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match="SERVING-only"):
        cli.main(["--synthetic", *CPU, *TINY, "model.backbone.quant=int8",
                  f"output_dir={tmp_path}"])
    if not torch.cuda.is_available():       # CUDA unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--synthetic", *TINY, f"output_dir={tmp_path}"])


def test_trunk_ckpt_loads_a_dinov2_trunk(tmp_path, monkeypatch):
    """--trunk-ckpt with a torch.hub DINOv2 file (tools/train_net.py:229-
    233): the frozen trunk trains from the file's weights (equal to the
    converted tree, bit for bit, after the steps) and the depth-fusion conv
    from the seeded init."""
    from ovmono3d_tpu_torch.config import load_config
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    from ovmono3d_tpu_torch.utils import flax_bridge, release_states
    from ovmono3d_tpu_torch.utils.cnn_convert import _convert_vit_trunk

    cfg = load_config(None, overrides=TINY)
    bb = cfg.model.backbone
    state = release_states.dinov2_hub_state(
        bb.embed_dim, bb.depth, bb.patch_size, bb.pretrain_grid, seed=2)
    path = tmp_path / "dinov2_vit.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    built = []
    monkeypatch.setattr(cli, "build_model", lambda *a, **k: built.append(
        build_model(*a, **k)) or built[-1])
    res = cli.main(["--synthetic", *CPU, "--max-iter", "2", "--batch-size",
                    "8", "--trunk-ckpt", str(path), *TINY,
                    "solver.checkpoint_period=1000", "test.eval_period=0",
                    f"output_dir={tmp_path / 'out'}"])
    assert res["step"] == 2 and res["skipped"] == 0
    vit = built[0].backbone.vit
    seeded = build_model(cfg.model, device="cpu",
                         seed=cfg.seed).backbone.vit
    assert torch.equal(vit.depth_fusion.weight, seeded.depth_fusion.weight)
    tree = _convert_vit_trunk(state, "dinov2")
    ref = dict(vit.named_parameters())
    keep = ("depth_fusion.weight", "depth_fusion.bias")
    for name, arr in flax_bridge.torch_arrays(vit, tree, keep).items():
        np.testing.assert_array_equal(ref[name].detach().numpy(), arr)


@pytest.mark.parametrize("name", ["clip", "mae", "midas", "sam", "dla34"])
def test_trunk_ckpt_refuses_the_unported_trunks(tmp_path, monkeypatch, name,
                                                tiny_presets):
    """Once refusals, now loads: --trunk-ckpt with a tiny seeded trunk in
    its released layout trains one step with the trunk frozen, and every
    parameter and BatchNorm buffer of the trunk then equals the JAX
    load_cnn_trunk's leaf for the same file, bit for bit."""
    from ovmono3d_tpu.utils import cnn_convert as jcnn
    from ovmono3d_tpu_torch.models.rcnn3d import build_model

    overrides = [*TINY, f"model.backbone.name={name}",
                 "model.backbone.square_pad=128",
                 "model.backbone.scale_factors=(4.0,2.0,1.0)"]
    pcfg = cli.load_config(None, overrides=overrides)
    path = tmp_path / f"{name}.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                trunk_state(name, pcfg.model.backbone, seed=3).items()}, path)
    built = []
    monkeypatch.setattr(cli, "build_model", lambda *a, **k: built.append(
        build_model(*a, **k)) or built[-1])
    res = cli.main(["--synthetic", *CPU, "--max-iter", "1", "--batch-size",
                    "2", "--trunk-ckpt", str(path), *overrides,
                    "solver.checkpoint_period=1000", "test.eval_period=0",
                    f"output_dir={tmp_path / 'out'}"])
    assert res["step"] == 1
    jmodel_cfg = jcfg.load_config(None, overrides=overrides).model
    jvariables = jcnn.load_cnn_trunk(jax_init_tree(jmodel_cfg), path, name)
    assert_trunk_equal(built[0], jvariables)


@pytest.fixture(scope="module")
def tinyds(tmp_path_factory):
    return build_dataset(tmp_path_factory.mktemp("tiny_omni3d"))


FIXTURE = [*TINY[:-2], "model.num_classes=2", "model.max_detections=16",
           "input.min_size_train=96", "input.max_size_train=112",
           "input.min_size_test=96", "input.max_size_test=112",
           f"datasets.category_names={','.join(CATEGORY_NAMES)}"]


def test_real_loader_train_then_offline_evaluation(tmp_path, tinyds, capsys):
    data = [f"datasets.data_root={tinyds['root']}",
            f"datasets.depth_dir={tinyds['root'] / 'depth'}"]
    out_dir = tmp_path / "out"
    cli.main([*CPU, "--max-iter", "3", "--batch-size", "8", *FIXTURE, *data,
              "datasets.train=TinyDS_train", "test.eval_period=0",
              "solver.checkpoint_period=3", f"output_dir={out_dir}"])
    assert (out_dir / "model_recent.pt").exists()
    metrics = [json.loads(line) for line in
               (out_dir / "metrics.jsonl").read_text().splitlines()]
    assert metrics and np.isfinite(metrics[-1]["total_loss"])
    priors = np.load(out_dir / "priors.npz")
    assert np.all(priors["dims"][:, 0] > 0)
    dump = tmp_path / "preds"
    capsys.readouterr()
    eval_cli.main([*CPU, "--batch-size", "4", "--checkpoint",
                   str(out_dir / "model_recent.pt"), "--dump-predictions",
                   str(dump), *FIXTURE, *data,
                   "datasets.test_base=TinyDS_test", "test.cat_mode=base",
                   "test.oracle2d=true",
                   "datasets.oracle2d_files.target_aware.base.TinyDS_test="
                   f"{tinyds['oracle']}"])
    out = capsys.readouterr().out
    assert re.search(r"AP2D\s*\| 100\.00", out), out
    dump_file = f"{dump}_TinyDS_test.json"
    preds = json.load(open(dump_file))
    assert {p["image_id"] for p in preds} <= {100, 101, 102, 103}
    assert any(p["instances"] for p in preds)
    predictions.main(["--predictions", dump_file, "--dataset-json",
                      str(tinyds["root"] / "Omni3D" / "TinyDS_test.json"),
                      "--categories", ",".join(CATEGORY_NAMES), *CPU])
    assert re.search(r"AP2D\s*\| 100\.00", capsys.readouterr().out)
