"""What the training panels need of ovmono3d_tpu/utils/util.py: the color
table and an RGB image writer. The writer encodes PNG itself
(data/build.py `encode_png`): the machine with the card has no OpenCV."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ovmono3d_tpu_torch.data.build import encode_png

# COCO-style color table (subset; cycled with jitter like the reference's
# util.py:131-300).
_COLORS = [
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207), (174, 199, 232), (255, 187, 120),
    (152, 223, 138), (255, 152, 150), (197, 176, 213), (196, 156, 148),
]


def get_color(index: int, jitter: bool = False) -> tuple[int, int, int]:
    c = _COLORS[index % len(_COLORS)]
    if jitter:
        rng = np.random.RandomState(index)
        c = tuple(int(np.clip(v + rng.randint(-20, 20), 0, 255)) for v in c)
    return tuple(int(v) for v in c)


def imwrite_rgb(path, image: np.ndarray) -> None:
    """[H, W, 3] RGB (cast to uint8) as a PNG file; parents are made."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(np.asarray(image).astype(np.uint8)))
