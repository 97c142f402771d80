"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each library is compiled at first use from the sources under
`ovmono3d_tpu_torch/csrc/` into `build/kernels/` at the repository root, for
`sm_90a` (Hopper). The file name carries a hash of the sources and flags, so
a changed `.cu` builds anew and an unchanged one is loaded as it is. The
sources use a plain C interface (no PyTorch headers), which keeps a build to
seconds.

The port therefore runs from a source checkout (or an editable install,
`pip install -e .[torch]`): a wheel carries no `.cu` files and has no
checkout to build into.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the "
            "port's CUDA kernels are built from source on the GPU machine")
    return found


def library_path(name: str, sources: list[str]) -> Path:
    """Where the library built from `sources` (names under csrc/) lives."""
    if not CSRC.is_dir():
        raise RuntimeError(
            f"no kernel sources at {CSRC}: the port's CUDA kernels build from "
            "a source checkout (or an editable install)")
    h = hashlib.sha256()
    for src in sorted(sources):
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, sources: list[str]) -> Path:
    """Compile `sources` into a shared library unless it is already built.

    The compiler's resource report (-Xptxas -v: registers, shared memory,
    spills) is kept beside the library as `<lib>.log`.
    """
    out = library_path(name, sources)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent build never loads half a file
    return out


def load(name: str, sources: list[str]) -> ctypes.CDLL:
    """Build if needed, then dlopen the library."""
    return ctypes.CDLL(str(build(name, sources)))
