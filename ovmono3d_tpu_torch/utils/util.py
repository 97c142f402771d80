"""Generic utilities (counterpart of ovmono3d_tpu/utils/util.py, the
reference's cubercnn/util/util.py): the color table, JSON and pickle files,
image files, and a wall-clock ETA.

Images are read and written without OpenCV, which the machine with the card
lacks: PNG through the port's own codec (data/build.py `read_png` /
`encode_png`), any other format through PIL, imported only when such a file
is read."""
from __future__ import annotations

import json
import pickle
import time
from pathlib import Path

import numpy as np

from ovmono3d_tpu_torch.data.build import encode_png, read_png

# COCO-style color table (subset; cycled with jitter like the reference's
# util.py:131-300).
_COLORS = [
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207), (174, 199, 232), (255, 187, 120),
    (152, 223, 138), (255, 152, 150), (197, 176, 213), (196, 156, 148),
]
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def get_color(index: int, jitter: bool = False) -> tuple[int, int, int]:
    c = _COLORS[index % len(_COLORS)]
    if jitter:
        rng = np.random.RandomState(index)
        c = tuple(int(np.clip(v + rng.randint(-20, 20), 0, 255)) for v in c)
    return tuple(int(v) for v in c)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def save_json(path, obj) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def load_pickle(path):
    """Unpickle a file this program wrote (unpickling runs code: never
    point it at a file from elsewhere)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(path, obj) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def imread_rgb(path) -> np.ndarray:
    """An image file as [H, W, 3] uint8 RGB. PNG is decoded by `read_png`;
    JPEG and the other formats by PIL, which must then be installed (the
    error names the format otherwise). FileNotFoundError for a missing
    file."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG_MAGIC:
        return read_png(path)
    kind = "JPEG" if head[:3] == b"\xff\xd8\xff" else path.suffix or "?"
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading {kind} needs PIL (Pillow), "
                          "which is not installed; PNG needs nothing") from e
    with Image.open(path) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"), np.uint8))


def imwrite_rgb(path, image: np.ndarray) -> None:
    """[H, W, 3] RGB (cast to uint8) as a PNG file; parents are made."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(np.asarray(image).astype(np.uint8)))


def list_images(folder) -> list[Path]:
    """The image files of `folder` (by extension, any case), sorted."""
    return sorted(p for p in Path(folder).iterdir()
                  if p.suffix.lower() in IMAGE_EXTS)


class ETA:
    """Wall-clock ETA tracker (util.py compute_eta)."""

    def __init__(self, total: int):
        self.total = total
        self.start = time.time()
        self.done = 0

    def step(self, n: int = 1) -> str:
        self.done += n
        dt = time.time() - self.start
        rate = self.done / max(dt, 1e-6)
        remain = (self.total - self.done) / max(rate, 1e-9)
        return f"{self.done}/{self.total} ({rate:.2f}/s, eta {remain:.0f}s)"
