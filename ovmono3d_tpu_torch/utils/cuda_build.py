"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `ovmono3d_tpu_torch/csrc/` becomes its own shared library,
compiled at first use into `build/kernels/` at the repository root, for
`sm_90a` (Hopper). The sources a call asks for are compiled in parallel, one
nvcc process each, all started together. A library's file name carries a
hash of its source, of every header in `csrc/` and of the flags, so a changed
file builds anew and an unchanged one is loaded as it is. The sources use a
plain C interface (no PyTorch headers), which keeps a build to seconds.

`csrc` names another directory of sources where a probe builds an earlier
version of a kernel beside the shipped one (its `--previous`); its
libraries go to the same build directory, told apart by the hash.

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


def library_path(source: str, csrc: Path = CSRC) -> Path:
    """Where the library built from `source` (a file name under `csrc`)
    lives."""
    if not csrc.is_dir():
        raise RuntimeError(
            f"no kernel sources at {csrc}: the port's CUDA kernels build from "
            "a source checkout (or an editable install)")
    h = hashlib.sha256()
    for path in [csrc / source, *sorted(csrc.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(sources: list[str], csrc: Path = CSRC) -> dict[str, Path]:
    """Compile every source not built yet, one nvcc each, all in parallel.

    The compiler's resource report (-Xptxas -v: registers, shared memory,
    spills) is kept beside each library as `<lib>.log`. Returns
    {source: library path}.
    """
    out = {src: library_path(src, csrc) for src in sources}
    todo = {src: lib for src, lib in out.items() if not lib.is_file()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for src, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(csrc / src)]
        procs[src] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        lib = todo[src]
        lib.with_name(lib.name + ".log").write_text(log)
        os.replace(tmp, lib)   # atomic: a concurrent build never loads half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(sources: list[str], csrc: Path = CSRC) -> dict[str, ctypes.CDLL]:
    """Build what is missing, then dlopen each library: {source: CDLL}."""
    return {src: ctypes.CDLL(str(lib))
            for src, lib in build(sources, Path(csrc)).items()}
