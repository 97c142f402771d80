"""The open-vocabulary stream cell on the CPU at tiny sizes: the plain
GroundingDINO reference against the port computing in float32 (its own
top-k choice, and the program's choice given), its prompt masks and
postprocess against the port's, gdino_flops.py against
torch.utils.flop_counter, and whole runs of the `stream` driver, sound and
with a decoder layer left out, and the stream's controls judged by the
cell's limits."""
import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import controls_stream, gdino_flops, harness
from benchmark.reference import gdino as R
from benchmark.tests import tiny
from benchmark.traffic import stream

WORKLOAD = "ov-stream-c8"
CATS = ["chair", "table", "traffic cone", "night stand", "bin"]


def config() -> dict:
    cfg = tiny.config("lift-dinov2-vitb14")
    full = harness.read_json("configs", "ov-gdino-swinb-dinov2")
    g = copy.deepcopy(full["gdino"])
    g["swin"].update(embed_dim=8, depths=[2, 2, 2, 2], heads=[1, 2, 4, 8],
                     window=4)
    g["bert"].update(layers=1, hidden=32, heads=2, intermediate=64)
    g["transformer"].update(hidden=32, heads=2, enc_layers=2, dec_layers=2,
                            queries=16, enc_points=2, dec_points=2, ffn=64)
    g.update(max_text_len=32, detect_topk=10)
    cfg["gdino"] = g
    cfg["gdino_weight_means"] = {f"fusion{i}.{n}.weight": 1.0
                                 for i in range(2) for n in ("ln_v", "ln_l")}
    cfg["input"].update(min_size_test=84, max_size_test=112)
    return cfg


def make_run(seed=2**31 + 21, seconds=0.3, trace=False) -> harness.Run:
    traffic = copy.deepcopy(harness.read_json("workloads", WORKLOAD))
    traffic.update(chunk=2, pool=4, categories=CATS,
                   camera_sizes=[[160, 120], [120, 160], [150, 100]],
                   short_sides=[84], max_long=112)
    return harness.Run(workload=WORKLOAD, cfg=config(), traffic=traffic,
                       seed=seed, seconds=seconds, trace=trace,
                       device="cpu")


@pytest.fixture
def f32_stream(monkeypatch):
    """The driver builds the pipeline computing in float32."""
    build = stream.build

    def f32_build(run, device):
        pipe, wc, wg = build(run, device)
        tiny.to_f32(pipe.gdino)
        tiny.to_f32(pipe.rcnn)
        return pipe, wc, wg
    monkeypatch.setattr(stream, "build", f32_build)


def program_rows(run, pipe) -> list[tuple]:
    """The pool's first chunk through the port's stream, its rows
    captured."""
    return controls_stream.program_rows(run, pipe, stream.frames(run, "cpu"),
                                        [0, 1])


def test_reference_follows_the_port(f32_stream):
    run = make_run()
    pipe, wc, wg = stream.build(run, "cpu")
    text = stream.text_inputs(pipe, CATS)
    rows = program_rows(run, pipe)
    for frame, _, cap, _ in rows:
        canvas, hw, _ = stream.ref_canvas(run, torch.as_tensor(frame))
        assert torch.equal(hw, cap["hw"].long())
        # On the program's own canvas the reference makes its choice and
        # computes what the port computed.
        ref = stream.reference(run, wg, cap["canvas"], hw, text)
        assert torch.equal(ref["query_index"][0], cap["query_index"])
        gaps = stream.Gaps()
        stream.add_detector(gaps, cap, ref, text["text_mask"])
        for k in ("memory_gap", "hs_gap", "logits_gap", "boxes_gap",
                  "text_gap"):
            assert gaps.numbers()[k] < 1e-4, (k, gaps.numbers())
    nums = stream.check_rows(run, wc, wg, rows, text).numbers()
    assert set(run.traffic["limits"]) <= set(nums)
    # Pixels whose resize lands within rounding of a half differ by one
    # level, and the reference's canvas carries that on.
    assert nums["canvas_gap"] < 2e-3, nums
    assert nums["topk_miss"] < 0.1, nums
    for k in ("memory_gap", "hs_gap", "logits_gap", "boxes_gap",
              "corners_rms_gap"):
        assert nums[k] < 1e-2, (k, nums)
    assert nums["text_gap"] < 1e-5 and nums["score_gap"] < 1e-3, nums


def test_reference_given_the_programs_indices(f32_stream, monkeypatch):
    """The port choosing other queries than the top scores: the reference
    given the program's indices computes what the port computed past the
    selection, and its own choice differs."""
    run = make_run()
    pipe, wc, wg = stream.build(run, "cpu")
    text = stream.text_inputs(pipe, CATS)
    with controls_stream.Fault("fault_selection", pipe, 0):
        rows = program_rows(run, pipe)
    nums = stream.check_rows(run, wc, wg, rows, text).numbers()
    assert nums["topk_miss"] > 0.5
    assert nums["logits_gap"] < 2e-3 and nums["boxes_gap"] < 2e-3, nums


def test_controls_are_judged_by_the_cells_limits(f32_stream):
    """The controls' readings on the CPU: the sound program correct by the
    traffic's limits, each fault not, and every fault patch undone."""
    from ovmono3d_tpu_torch.models.gdino import model as port_model
    from ovmono3d_tpu_torch.models.ovmono3d import OVMono3DLift
    topk, canvas = port_model.stable_topk, OVMono3DLift._stream_canvas
    got = {}
    controls_stream.seed_readings(
        make_run(), torch.device("cpu"), lambda k, v: got.setdefault(k, v),
        skip_layer=1, readings=("program", *controls_stream.FAULTS,
                                "reference_bf16"))
    assert got["program"]["correct"], got["program"]
    assert got["fault_selection"]["over_limit"] == ["topk_miss"]
    assert "canvas_gap" in got["fault_stacking"]["over_limit"]
    assert not got["fault_skip_decoder_layer"]["correct"]
    assert set(make_run().traffic["limits"]) <= set(
        got["reference_bf16"]["values"])
    assert port_model.stable_topk is topk
    assert OVMono3DLift._stream_canvas is canvas


def test_prompt_masks_and_postprocess_match_the_port():
    from ovmono3d_tpu_torch.eval.oracle2d import category_tokenizer
    from ovmono3d_tpu_torch.models.gdino.bert import build_subsentence_masks
    from ovmono3d_tpu_torch.models.gdino.inference import (
        build_text_inputs, postprocess_grounding)
    tok = category_tokenizer(CATS)
    text = build_text_inputs(tok, CATS, max_len=32)
    special = (tok.cls_id, tok.sep_id, tok.period_id, tok.question_id)
    mask, pos = R.subsentence_masks(torch.from_numpy(text["input_ids"]),
                                    special)
    want_mask, want_pos = build_subsentence_masks(text["input_ids"], special)
    assert torch.equal(mask, torch.from_numpy(want_mask))
    assert torch.equal(pos, torch.from_numpy(want_pos).long())
    g = torch.Generator().manual_seed(4)
    logits = 3 * torch.randn(40, 32, generator=g)
    boxes = 0.2 + 0.5 * torch.rand(40, 4, generator=g)
    span = torch.from_numpy(text["span_matrix"])
    valid = torch.from_numpy(text["span_valid"])
    got = R.postprocess(logits, boxes, span, valid, 112.0, 10, 0.001, 0.5)
    want = postprocess_grounding(logits, boxes, span, valid, (112.0, 112.0),
                                 topk=10)
    for k, w in zip(("boxes", "scores", "classes", "valid"), want):
        torch.testing.assert_close(got[k], w, msg=k)


def test_flops_match_the_counter():
    """The detector's analytic count less deformable sampling, which the
    counter does not see, is what FlopCounterMode counts in the
    reference."""
    cfg = config()
    g = cfg["gdino"]
    from ovmono3d_tpu_torch.models.gdino.model import GroundingDINO
    from benchmark import weights
    model = GroundingDINO(**stream.gdino_kwargs(g), device="meta")
    w = weights.draw(weights.specs_of(model), 3, "cpu")
    side, T = cfg["model"]["backbone"]["square_pad"], 16
    image = torch.randn(1, side, side, 3)
    ids = torch.randint(5, 12, (1, T))
    ids[0, 0], ids[0, -1] = 2, 3
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        R.encode(R.Precision(), w, g, image, ids,
                 torch.ones(1, T, dtype=torch.bool), (2, 3, 4, 4))
    t = g["transformer"]
    S = sum(h * w for h, w in gdino_flops.level_shapes(g, side))
    sampling = (t["enc_layers"] * gdino_flops.sampling_flops(
        g, S, t["enc_points"]) + t["dec_layers"] * gdino_flops.sampling_flops(
        g, t["queries"], t["dec_points"]))
    assert fc.get_total_flops() == gdino_flops.detector_flops(
        g, side, T) - sampling


def test_bounds_at_the_cells_sizes():
    cfg = harness.read_json("configs", "ov-gdino-swinb-dinov2")
    g = cfg["gdino"]
    assert sum(h * w for h, w in gdino_flops.level_shapes(g, 896)) == 16660
    blocks = gdino_flops.swin_blocks(g, 896)
    assert len(blocks) == 24
    assert [b["windows"] for b in blocks[:5]] == [361, 361, 100, 100, 25]
    # Stage 0's shifted launch, PERF.md section 6 row 8: 53.8 MB, 0.0161 ms.
    assert gdino_flops.window_launch_bound_s(blocks[1]) == pytest.approx(
        53.77e6 / 3.35e12, rel=1e-3)
    # The stream's chunk of 8 in one launch: q, k, v and o of every image,
    # the bias and the region ids once.
    assert gdino_flops.window_launch_bound_s(blocks[1], 8) == pytest.approx(
        (8 * 53.2316e6 + 0.5397e6) / 3.35e12, rel=1e-3)
    assert gdino_flops.window_bound_s(cfg, 8) < 8 * gdino_flops.window_bound_s(
        cfg)


def test_sound_run_is_correct(f32_stream):
    run = make_run()
    stream.run(run)
    assert run.correct, run.checks
    assert set(run.checks) == set(run.traffic["limits"])
    assert run.attempted > 0 and run.failed == 0


def test_a_skipped_decoder_layer_fails(f32_stream, monkeypatch):
    build = stream.build

    def faulty(run, device):
        pipe, wc, wg = build(run, device)
        pipe.gdino.dec1.forward = lambda tgt, *args: tgt
        return pipe, wc, wg
    monkeypatch.setattr(stream, "build", faulty)
    run = make_run()
    stream.run(run)
    assert not run.correct, run.checks
    assert run.checks["hs_gap"][0] > run.checks["hs_gap"][1], run.checks


def test_a_port_without_the_capture_stops_at_once(monkeypatch):
    from ovmono3d_tpu_torch.models.ovmono3d import OVMono3DLift
    monkeypatch.setattr(OVMono3DLift, "predict_stream",
                        lambda self, items, categories, chunk=8,
                        devices=None: iter(()))
    with pytest.raises(SystemExit, match="capture"):
        stream.run(make_run())


def test_traced_run_reads_its_window(f32_stream):
    run = make_run(seconds=1.0, trace=True)
    stream.run(run)
    assert run.traced is not None and run.work["images"] > 0
    assert harness.load_module("metrics", "mfu.stream").read(run) > 0
    # The spans' host time; their device time needs the card.
    assert harness.load_module("metrics", "host_ms.stream").read(run) > 0
    assert harness.load_module("metrics", "swin_ms.stream").read(run) is None


def test_the_cells_modules_load_no_jax():
    """What a run of the cell and its controls import, in a fresh
    process."""
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import harness, controls_stream;"
            "import benchmark.run;"
            "harness.load_module('traffic', 'stream');"
            "[harness.load_module('metrics', m['name']) for m in "
            "harness.manifest()['per_layer']];"
            "import ovmono3d_tpu_torch.models.ovmono3d, "
            "ovmono3d_tpu_torch.parallel.serve, "
            "ovmono3d_tpu_torch.eval.oracle2d;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
