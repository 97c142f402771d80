"""The test side of the data pipeline (counterpart of the test half of
ovmono3d_tpu/data/build.py): sequential fixed-shape batches and an image
loader that needs neither cv2 nor PIL.

- `build_test_iterator`: each record once, in order (InferenceSampler
  semantics), mapped by `data/mapper.py` and stacked; the last chunk is
  padded by repeating its final record. The JAX package's optional native
  resize (`native/preproc.cc`) has no counterpart yet: the mapper resizes
  each image with torch on the CPU.
- `default_image_loader`: record["file_name"] under the data root as RGB
  uint8, or None when the file is missing (a zero image, as in the JAX
  package). The machine with the card has no cv2 and no PIL, so 8-bit PNG
  (the format the repository's fixtures write) is decoded here with zlib and
  numpy (`read_png`); any other format raises, naming it. `write_png` writes
  it, for test data made where cv2 is missing.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Iterator

import numpy as np

from ovmono3d_tpu_torch.config import Config
from ovmono3d_tpu_torch.data.mapper import batch_examples, map_example

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # grey, RGB, grey + alpha, RGBA


def build_test_iterator(cfg: Config, records: list[dict], batch_size: int = 1,
                        image_loader=None, max_oracle: int = 64
                        ) -> Iterator[tuple[list[dict], dict]]:
    """Yields (records_chunk, batch) with the model's keyword names; the
    caller drops the padded slots by the chunk's length."""
    for start in range(0, len(records), batch_size):
        chunk = records[start:start + batch_size]
        padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
        examples = [
            map_example(r, cfg, image=(image_loader(r) if image_loader
                                       is not None else None),
                        is_train=False, max_oracle=max_oracle)
            for r in padded
        ]
        yield chunk, _to_model_batch(batch_examples(examples))


def _to_model_batch(b: dict) -> dict:
    """numpy batch dict -> the model's keyword names."""
    out = {k: b[k] for k in ("image", "K", "im_hw", "im_scale_ratio")}
    for k in ("gt_boxes", "gt_classes", "gt_boxes3d", "gt_poses", "gt_valid",
              "oracle_boxes", "oracle_classes", "oracle_scores",
              "oracle_valid", "depth"):
        if k in b:
            out[k] = b[k]
    return out


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-scanline filters (None, Sub, Up, Average, Paeth)."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            # Each byte depends on the reconstructed byte bpp to its left.
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + prev[x]) >> 1
                else:
                    up_left = prev[x - bpp] if x >= bpp else 0
                    p = left + prev[x] - up_left
                    pa, pb, pc = abs(p - left), abs(p - prev[x]), \
                        abs(p - up_left)
                    pred = (left if pa <= pb and pa <= pc
                            else prev[x] if pb <= pc else up_left)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter type {kind} on row {y}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced PNG (grey, grey + alpha, RGB or RGBA) as
    [H, W, 3] uint8 RGB (alpha dropped, grey repeated, as cv2's
    IMREAD_COLOR). Raises ValueError for any other file."""
    data = Path(path).read_bytes()
    if not data.startswith(_PNG_MAGIC):
        kind = ("JPEG" if data[:3] == b"\xff\xd8\xff" else
                "an unknown format")
        raise ValueError(f"{path}: {kind}; the port's image loader reads "
                         "8-bit PNG only (no cv2 or PIL on the GPU machine)")
    pos, header, idat = len(_PNG_MAGIC), None, []
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}; the loader reads "
                         "8-bit non-interlaced grey, RGB or RGBA")
    ch = _CHANNELS[color]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    pix = pix.reshape(h, w, ch)
    if ch < 3:
        pix = np.repeat(pix[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pix[..., :3])


def write_png(path, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 RGB as an 8-bit RGB PNG (every scanline unfiltered),
    the format `read_png` reads: for writing test data where cv2 is
    missing."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    Path(path).write_bytes(
        _PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                                0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes()))
        + chunk(b"IEND", b""))


def default_image_loader(data_root: str):
    """Loads record['file_name'] relative to data_root as RGB uint8; None
    for a missing file."""

    def load(rec: dict):
        path = Path(data_root) / rec["file_name"]
        if not path.exists():
            return None
        return read_png(path)

    return load
