"""The multi-tensor SGD update (`csrc/multi_tensor_sgd.cu`) at the trainable
sets of the two benchmarked detectors, on the card.

    python -m ovmono3d_tpu_torch.probes.optim [--repeats R] [--set NAME]

Leaves as `build_model(device="meta")` shapes and groups them: SAM ViT-B
trained unfrozen (configs/OVMono3D_sam_SFP.yaml with
model.backbone.freeze=false: 237 leaves, 121.17 M float32) and the DINOv2
flagship with its trunk frozen (configs/OVMono3D_dinov2_SFP.yaml: 48
leaves, 32.10 M), parameters and gradients drawn from seed 0, the solver
of each file. First it holds the kernel path to the per-leaf update
(`check`): parameters and trace bit for bit over three steps, one of them
on gradients that are views at an odd offset into one flat buffer (as the
data-parallel step's all_reduce buffer gives them), and a skipped step on
gradients holding a NaN and an inf, which both paths' flags see. Then it
times, by CUDA events and by the profiler's device time:
  sgd      one `sgd_update` launch alone, beside its byte bound (g, p and
           trace read, p and trace written: 20 bytes an element);
  finite   one `all_finite` launch alone (4 bytes an element);
  step     `Optimizer.step` on the kernel path (the schedule, the launch,
           the count), with its host ms and launches;
  eager    the per-leaf `Optimizer.step` the kernel replaces, likewise;
  foreach  the finiteness flag the kernel replaces (`_foreach_mul` of the
           gradients by 0, `_foreach_norm`, the sum);
  library  PyTorch's own multi-tensor SGD, `torch._fused_sgd_` once per
           group (its tensor lr, its found_inf as the skip), and how many
           elements of parameters and trace it leaves other than the
           kernel does after three steps: it computes g + wd * p, the trace
           and p - lr * trace in double, each rounded to f32 once, where
           optax's f32 arithmetic rounds every product and sum;
  amp      the flag by `torch._amp_foreach_non_finite_check_and_unscale_`
           with a scale of 1 (it also writes every gradient back).
Each by CUDA events around one call, by events around ten calls in a row
(a call's share: where the host issues calls faster than the device runs
them, the device's pace), by the profiler's device time and by host time.
The profiler has missed some of the library's kernels on the H100 (device
times under the byte bound), so the library is compared in a row. With
--repeats R each timing is taken R times in turns.
"""
from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path

import torch

from ovmono3d_tpu_torch.ops import optim_kernels as ok
from ovmono3d_tpu_torch.probes import PEAK_BYTES, card, device_ms, time_ms
from ovmono3d_tpu_torch.train.optim import GROUPS

REPO = Path(__file__).resolve().parents[2]
SETS = {"sam": ("OVMono3D_sam_SFP.yaml", ["model.backbone.freeze=false"]),
        "dinov2": ("OVMono3D_dinov2_SFP.yaml", [])}


def optimizers(name: str, device="cuda"):
    """(kernel optimizer, per-leaf optimizer, gradients) over two equal
    copies of the set's trainable leaves."""
    from ovmono3d_tpu_torch.config import load_config
    from ovmono3d_tpu_torch.models.rcnn3d import build_model, freeze_trunk
    from ovmono3d_tpu_torch.train.optim import Optimizer

    path, overrides = SETS[name]
    cfg = load_config(REPO / "configs" / path, overrides)
    opts = []
    for _ in range(2):
        model = build_model(cfg.model, device="meta").to_empty(device=device)
        freeze_trunk(model, cfg.model.backbone.freeze)
        opts.append(Optimizer(cfg.solver, model))
    kern, eager = opts
    eager.kernel = None
    g = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        for p, q in zip(kern.params, eager.params):
            p.copy_(torch.randn(p.shape, generator=g, device=device))
            q.copy_(p)
    grads = [torch.randn(p.shape, generator=g, device=device)
             for p in kern.params]
    return kern, eager, grads


def library_sgd(opt):
    """`torch._fused_sgd_` over `opt`'s leaves, one call per group:
    fn(params, traces, grads, lr [3] on the device, found_inf float)."""
    idx = {g: [i for i, lab in enumerate(opt.labels) if lab == g]
           for g in GROUPS}

    def run(params, traces, grads, lr, found_inf):
        for k, g in enumerate(GROUPS):
            if idx[g]:
                torch._fused_sgd_(
                    [params[i] for i in idx[g]], [grads[i] for i in idx[g]],
                    [traces[i] for i in idx[g]],
                    weight_decay=opt.groups[g][1], momentum=opt.momentum,
                    lr=lr[k], dampening=0.0, nesterov=False, maximize=False,
                    is_first_step=False, found_inf=found_inf)
    return run


def _state(opt) -> list[torch.Tensor]:
    return opt.params + opt.state["trace"]


def _copy_state(src, dst) -> None:
    with torch.no_grad():
        for a, b in zip(_state(src), _state(dst)):
            b.copy_(a)
        dst.count.copy_(src.count)


def _same_bits(a: list, b: list) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def check(kern, eager, grads) -> list[tuple[str, bool]]:
    """The kernel path against the per-leaf update from one state:
    (what, held) for the bits after each step, the skip and the flags."""
    _copy_state(kern, eager)
    sizes = [p.numel() for p in kern.params]
    flat = torch.empty(1 + sum(sizes), device=kern.device)
    views = [v.view(p.shape) for v, p in
             zip(flat[1:].split(sizes), kern.params)]
    with torch.no_grad():
        for v, g in zip(views, grads):
            v.copy_(g)
    bad = list(grads)      # a NaN mid first leaf, an inf ending the last
    bad[0], bad[-1] = grads[0].clone(), grads[-1].clone()
    bad[0].view(-1)[sizes[0] // 2 + 1] = float("nan")
    bad[-1].view(-1)[-1] = float("inf")
    out = []
    for what, gs in (("separate gradients", grads),
                     ("views at offset 1 of one buffer", views),
                     ("separate gradients again", grads)):
        flags = kern.all_finite(gs), eager.all_finite(gs)
        out.append((f"flag on {what}: kernel and per-leaf true",
                    bool(flags[0]) and bool(flags[1])))
        skip = ~flags[0]
        kern.step(gs, skip)
        eager.step(gs, skip)
        out.append((f"step on {what}: parameters and trace bit for bit",
                    _same_bits(_state(kern), _state(eager))))
    before = [t.clone() for t in _state(kern)]
    flags = kern.all_finite(bad), eager.all_finite(bad)
    out.append(("flag on a NaN and an inf: kernel and per-leaf false",
                not bool(flags[0]) and not bool(flags[1])))
    kern.step(bad, ~flags[0])
    eager.step(bad, ~flags[1])
    out.append(("skipped step: every bit kept, both paths",
                _same_bits(_state(kern), before)
                and _same_bits(_state(eager), before)
                and int(kern.count) == int(eager.count) == 3))
    return out


def burst_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """CUDA-event ms a call over `calls` calls in a row, median of
    `reps`."""
    return time_ms(lambda: [fn() for _ in range(calls)], reps=reps) / calls


def host_ms(fn, reps: int = 5) -> float:
    """Median host ms of a call, the device drained before each."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def measure(name: str, repeats: int) -> tuple[list[str], dict]:
    """The probe's lines for set `name`, and its rows {"sgd", "finite"}:
    each kernel's event and device ms, the call it replaces (`plain_*`),
    PyTorch's multi-tensor call (`library_*`), its byte bound, launches a
    call and `library_differ` (elements of parameters and trace the library
    leaves otherwise than the kernel, after three steps). Raises
    SystemExit when a check fails."""
    kern, eager, grads = optimizers(name)
    n = sum(p.numel() for p in kern.params)
    held = check(kern, eager, grads)
    out = [f"{name}: {len(kern.params)} leaves, {n / 1e6:.2f} M float32, "
           f"{len(kern.kernel.chunks)} chunks of {ok.CHUNK}"]
    out += [f"  check: {what}: {'yes' if ok_ else 'NO'}"
            for what, ok_ in held]
    if not all(ok_ for _, ok_ in held):
        raise SystemExit("\n".join(out))

    skip = torch.zeros((), dtype=torch.bool, device=kern.device)
    found_inf = torch.zeros((), device=kern.device)
    scale = torch.ones((), device=kern.device)
    lr = kern._lrs(kern.count)
    lib = library_sgd(kern)
    # The library from the kernel's state: three steps each, then the bits.
    lib_state = [t.clone() for t in _state(kern)]
    lib_p, lib_t = lib_state[:len(kern.params)], lib_state[len(kern.params):]
    for _ in range(3):
        lr3 = kern._lrs(kern.count)
        lib(lib_p, lib_t, grads, lr3, found_inf)
        kern.step(grads, skip)
    with torch.no_grad():
        differ = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                     for a, b in zip(_state(kern), lib_state))
        worst = max(float((a - b).abs().max()) for a, b in
                    zip(_state(kern), lib_state))
    out.append(f"  library: {differ} of {2 * n} elements of parameters and "
               f"trace differ from the kernel's after three steps "
               f"(largest difference {worst:.3e})")

    launches = {}

    def counted(key, fn):
        def run():
            before = ok.sgd_update.launches + ok.all_finite.launches
            fn()
            launches[key] = (ok.sgd_update.launches + ok.all_finite.launches
                             - before)
        return run

    calls = {
        "sgd": (counted("sgd", lambda: ok.sgd_update(
            kern.kernel, grads, lr, skip, kern.momentum)), "sgd_kernel",
            20 * n),
        "finite": (counted("finite", lambda: kern.all_finite(grads)),
                   "finite_kernel", 4 * n),
        "step": (counted("step", lambda: kern.step(grads, skip)), "", None),
        "eager": (lambda: eager.step(grads, skip), "", None),
        "foreach": (lambda: eager.all_finite(grads), "", None),
        "library": (lambda: lib(lib_p, lib_t, grads, lr, found_inf), "",
                    None),
        "amp": (lambda: torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found_inf, scale), "", None),
    }
    times = {k: ([], [], [], []) for k in calls}
    for r in range(repeats):
        order = list(calls) if r % 2 == 0 else list(reversed(calls))
        for key in order:
            fn, match, _ = calls[key]
            times[key][0].append(time_ms(fn, reps=10))
            times[key][1].append(burst_ms(fn))
            times[key][2].append(device_ms(fn, match, reps=10))
            times[key][3].append(host_ms(fn))
    med = {k: tuple(statistics.median(v) for v in vs)
           for k, vs in times.items()}
    for key, (fn, match, nbytes) in calls.items():
        ev, burst, dev, host = med[key]
        line = (f"  {key:<8} events {ev:.4f} ms, in a row {burst:.4f} ms "
                f"({' '.join(f'{d:.4f}' for d in times[key][1])}), device "
                f"{dev:.4f} ms ({' '.join(f'{d:.4f}' for d in times[key][2])}"
                f"), host {host:.3f} ms")
        if nbytes:
            bound = nbytes / PEAK_BYTES * 1e3
            line += (f"; bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB), "
                     f"{100 * bound / dev:.1f}% of it by device time, "
                     f"{100 * bound / burst:.1f}% in a row")
        if key in launches:
            line += f"; {launches[key]} kernel launch(es)"
        out.append(line)
    out.append(f"  found_inf after the library's timings: {float(found_inf)} "
               f"(0: no timed library call skipped its update)")
    rows = {}
    for key, plain, library in (("sgd", "eager", "library"),
                                ("finite", "foreach", "amp")):
        nbytes = calls[key][2]
        rows[key] = {
            "ms": med[key][0], "burst_ms": med[key][1],
            "device_ms": med[key][2],
            "plain_ms": med[plain][0], "plain_device_ms": med[plain][2],
            "library_ms": med[library][0],
            "library_burst_ms": med[library][1],
            "library_device_ms": med[library][2],
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "launches_a_call": launches[key], "max_abs_err": 0.0,
            "leaves": len(kern.params), "elements": n}
    rows["sgd"]["library_differ"] = differ
    rows["finite"]["library_differ"] = None     # a flag; not compared
    rows["sgd"]["library_max_abs_diff"] = worst
    return out, rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--set", choices=list(SETS), action="append")
    args = ap.parse_args(argv)
    print(f"card: {card()}")
    for name in args.set or list(SETS):
        for line in measure(name, args.repeats)[0]:
            print(line, flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
