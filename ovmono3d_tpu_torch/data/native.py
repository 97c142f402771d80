"""The batch resize, pad and pack in C++ with OpenMP (counterpart of
ovmono3d_tpu/data/native.py).

`native/preproc.cc` (the port's copy of the JAX package's source) resizes a
whole batch of uint8 RGB images to the shortest-edge rule, pads them onto
the square canvas and packs them as f32, one image per OpenMP thread,
without the interpreter lock. It is built at first use into `build/native/`
at the repository root, the library's name carrying a hash of the source,
the flags and the OpenMP runtime it links (as `utils/cuda_build.py` names
the kernels' libraries), and loaded with ctypes. The JAX package's own
build (`native/libpreproc.so`) is never loaded.

The build compiles with `g++ -O3 -fopenmp -fPIC -c` and links the object
`-shared` against a libgomp.so.1 by its path: PyTorch's own where it ships
one, else the compiler's. The compiler's OpenMP link step is not used: the
GPU machine's g++ lacks libgomp.spec, which `-fopenmp` at link time reads.
One runtime: the library's NEEDED libgomp.so.1 is the SONAME PyTorch's
libtorch_cpu needs too, so whichever loads first serves both, the library's
threads come from PyTorch's pool and `torch.set_num_threads` bounds them.

`build_test_iterator` takes this route when asked (`use_native=True`, its
default) and the machine has the cores for it (`native_worthwhile`); once
taken, a failed build or load raises: nothing falls back to the per-image
path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "preproc.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fopenmp", "-fPIC")
MIN_CORES = 4


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _run(cmd: list[str]) -> str:
    """A build command's stdout; RuntimeError with its output if it fails
    or cannot start."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native preprocessing build failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native preprocessing build failed with code "
                           f"{proc.returncode}: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


@functools.cache
def libgomp() -> Path:
    """The libgomp.so.1 the library links: PyTorch's (found without
    importing it), else the one the compiler knows. Raises without
    either."""
    spec = importlib.util.find_spec("torch")
    if spec is not None and spec.origin:
        bundled = Path(spec.origin).parent / "lib" / "libgomp.so.1"
        if bundled.is_file():
            return bundled
    found = Path(_run([_cxx(), "-print-file-name=libgomp.so.1"]).strip())
    if found.is_absolute() and found.is_file():
        return found
    raise RuntimeError("native preprocessing needs a libgomp.so.1: PyTorch "
                       "ships none and the compiler knows none")


def library_path() -> Path:
    """Where the library of the current source, flags and runtime lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(str(libgomp()).encode())
    return BUILD_DIR / f"libpreproc_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless it is there; returns its path.
    Raises RuntimeError with the compiler's output when g++ fails or is
    missing."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    obj = tmp.with_suffix(".o")
    gomp = libgomp()
    try:
        _run([_cxx(), *CXX_FLAGS, "-c", str(SOURCE), "-o", str(obj)])
        _run([_cxx(), "-shared", str(obj), str(gomp),
              f"-Wl,-rpath,{gomp.parent}", "-o", str(tmp)])
    finally:
        obj.unlink(missing_ok=True)
    os.replace(tmp, lib)   # atomic: a concurrent build never loads half a file
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then dlopen the library (once a process)."""
    lib = ctypes.CDLL(str(build()))
    lib.preprocess_batch.restype = ctypes.c_int
    lib.preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)]
    return lib


def native_worthwhile() -> bool:
    """Whether the batch path is expected to beat the per-image resize: its
    gain is OpenMP parallelism across images, and its scalar bilinear loop
    loses to a vectorised resize of one image at one core (the JAX
    package's measurement: 2.2x slower than cv2's). At least MIN_CORES."""
    return (os.cpu_count() or 1) >= MIN_CORES


def preprocess_batch_native(images: list[np.ndarray], out_size: int,
                            short_side: int, max_size: int):
    """uint8 RGB images [H, W, 3] -> (images [B, S, S, 3] f32 raw 0-255,
    zero-padded; im_hw [B, 2] int32 content; ratios [B] f32 original /
    network scale). The shortest side goes to `short_side`, the longest to
    at most min(max_size, out_size)."""
    lib = load()
    images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    for im in images:
        # The C loop walks the buffer as 3 interleaved channels: anything
        # else would read out of bounds or mix pixels.
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"native preprocess needs HWC RGB uint8, got "
                             f"{im.shape}")
    b = len(images)
    ptrs = (ctypes.c_void_p * b)(
        *[im.ctypes.data_as(ctypes.c_void_p) for im in images])
    heights = (ctypes.c_int * b)(*[im.shape[0] for im in images])
    widths = (ctypes.c_int * b)(*[im.shape[1] for im in images])
    out = np.zeros((b, out_size, out_size, 3), np.float32)
    out_hw = np.zeros((b, 2), np.int32)
    ratios = np.zeros((b,), np.float32)
    rc = lib.preprocess_batch(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), heights, widths,
        b, out_size, short_side, max_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ratios.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"preprocess_batch returned {rc}")
    return out, out_hw, ratios
