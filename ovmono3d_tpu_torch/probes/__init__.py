"""Probes of single kernels on the card: the port's counterparts of the JAX
package's TPU probes tools/probe_layernorm.py, tools/profile_attn_sweep.py
and tools/probe_int8_pallas.py (`python -m
ovmono3d_tpu_torch.probes.layernorm`, `... .attn_sweep`, `... .int8_gemm`),
and of the attention kernels' designs (`... .flash_fwd`, `... .relpos`,
`... .relpos_bwd`, `... .window`). Each
times its kernels by CUDA events beside their bounds, their plain versions
and a PyTorch call of the same function, and holds every kernel to its plain
version; chip_smoke.py reads their rows. Most also time an earlier
version of a kernel, built from a copy of its source that the caller names
(--previous), in turns with the shipped one."""
from __future__ import annotations

import statistics

import torch

# NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12                      # the FP32 pipes, no tensor cores


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event-timed calls of `fn`, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, match: str, reps: int = 20, sessions: int = 6) -> float:
    """The device time of the kernels whose name holds `match`, per call of
    `fn`, from torch.profiler's trace of `reps` calls (CUDA events around a
    call also count the host's launch time when the device waits on it).
    A profiling session now and then returns no device events at all (seen
    in a fresh process on the H100, three sessions in a row once), so up to
    `sessions` are tried."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and match in e.name]
        if us:
            return sum(us) / reps / 1e3
    raise RuntimeError(f"the profiler saw no kernel named *{match}* in "
                       f"{sessions} sessions")


def in_turns(calls: dict, reps: int = 20) -> dict:
    """{name: (event ms, device ms)} of each (fn, kernel-name match) in
    `calls`, timed in turns: the order given, then reversed, averaged
    (match "" counts every device op of a call)."""
    acc = {name: [0.0, 0.0] for name in calls}
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            fn, match = calls[name]
            acc[name][0] += time_ms(fn, reps) / 2
            acc[name][1] += device_ms(fn, match, reps) / 2
    return {name: tuple(v) for name, v in acc.items()}


def repeated(calls: dict, repeats: int, reps: int = 20) -> dict:
    """{name: [device ms of each repetition]}: in_turns `repeats` times,
    the call timed first rotating from one repetition to the next."""
    names = list(calls)
    out = {name: [] for name in names}
    for r in range(repeats):
        shift = r % len(names)
        order = names[shift:] + names[:shift]
        for name, (_, dev) in in_turns({x: calls[x] for x in order},
                                       reps).items():
            out[name].append(dev)
    return out


def spread(ts: list) -> str:
    """Each value, their median and their range, on one line."""
    return (f"{' '.join(f'{t:.4f}' for t in ts)}; median "
            f"{statistics.median(ts):.4f}, range {min(ts):.4f}-{max(ts):.4f}")


def previous_library(source: str, csrc: str):
    """The library built from the copy of `source` in the directory `csrc`:
    an earlier version of a kernel, which a probe's --previous times beside
    the shipped one (the copy is made outside the tree, for instance with
    `git archive <commit> ovmono3d_tpu_torch/csrc`)."""
    from pathlib import Path

    from ovmono3d_tpu_torch.utils import cuda_build

    return cuda_build.load([source], Path(csrc))[source]


def build_report(source: str, kernels: tuple, ops=("HGMMA", "UTMALDG")
                 ) -> list[str]:
    """One line for each instance of each kernel template named in
    `kernels` in the library built from `source`: its registers, spill
    stores and stack frame from the build's -Xptxas -v log, and its count of
    each SASS instruction in `ops` (cuobjdump, beside nvcc)."""
    import re
    import subprocess
    from pathlib import Path

    from ovmono3d_tpu_torch.utils import cuda_build

    lib = cuda_build.build([source])[source]
    log = lib.with_name(lib.name + ".log").read_text().splitlines()
    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1]
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                counts[fn][op] += len(re.findall(rf"\b{op}\b", line))
    out = []
    for i, line in enumerate(log):
        m = re.search(r"entry function '(\S+)'", line)
        name = next((k for k in kernels if m and k in m[1]), None)
        if name is None:
            continue
        report = " ".join(x.strip() for x in log[i + 1:i + 6]
                          if "Compiling entry" not in x)
        fields = [re.search(pat, report) for pat in (
            r"Used (\d+) registers", r"(\d+) bytes spill stores",
            r"(\d+) bytes stack frame")]
        regs, spills, stack = (f[1] if f else "?" for f in fields)
        inst = re.search(rf"{name}I((?:L[bi]\d+E)+)E", m[1])
        args = ",".join(re.findall(r"L[bi](\d+)E", inst[1])) if inst else ""
        c = counts.get(m[1], {})
        out.append(f"{name}<{args}>: {regs} registers, {spills} bytes spill "
                   f"stores, {stack} bytes stack frame; "
                   + ", ".join(f"{c.get(op, 0)} {op}" for op in ops))
    return out


def bf16_ulp_diff(got: torch.Tensor, want: torch.Tensor) -> tuple[int, int]:
    """(elements of `got` that differ from `want`, elements more than one
    bf16 ulp of `want` away). The ulp is taken at max(|want|, 2^-8), so
    outputs near zero are held to 2^-16 rather than to their own tiny ulp."""
    d = (got.float() - want.float()).abs()
    _, exp = torch.frexp(want.float().abs().clamp_min(2.0 ** -8))
    ulp = torch.ldexp(torch.ones_like(d), exp - 8)
    return int((d > 0).sum()), int((d > ulp).sum())


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
