"""The data pipeline (counterpart of ovmono3d_tpu/data/build.py):
weighted training streams and sequential test batches of fixed shape, and
an image loader that needs neither cv2 nor PIL.

- `build_train_iterator`: an endless weighted shuffle of training batches
  (images without a non-ignored annotation dropped first; dataset-balance
  and LVIS repeat-factor weights, `dataset_balance_weights` and
  `repeat_factors_from_category_frequency`; a seeded TRAIN_SET_PERCENTAGE
  subsample, `subsample_records`), mapped and stacked by producer threads
  with the JAX package's random streams. Its batches come in a fixed order
  whatever the threads' timing: producer t makes batches t, t + T, ...
- `build_test_iterator`: each record once, in order (InferenceSampler
  semantics), mapped by `data/mapper.py` and stacked; the last chunk is
  padded by repeating its final record. Its pixels go through the C++
  batch resize (`data/native.py`, the port's copy of `native/preproc.cc`)
  on a machine with at least 4 cores, else the mapper resizes each image
  with torch on the CPU.
- `default_image_loader`: record["file_name"] under the data root as RGB
  uint8, or None when the file is missing (a zero image, as in the JAX
  package), read by `utils/util.py` `imread_rgb`. The machine with the
  card has no cv2, so 8-bit PNG (the format the repository's fixtures
  write) is decoded here with zlib and numpy (`read_png`); other formats go
  through PIL, imported only then. `encode_png` / `write_png`
  write it (test data, the panels of train/metrics.py, eval --vis-dir and
  the demo, and their TensorBoard images) where cv2 is missing.
"""
from __future__ import annotations

import itertools
import logging
import math
import queue
import struct
import threading
import zlib
from collections import Counter
from pathlib import Path
from typing import Iterator

import numpy as np

from ovmono3d_tpu_torch.config import Config
from ovmono3d_tpu_torch.data import native
from ovmono3d_tpu_torch.data.mapper import batch_examples, map_example

logger = logging.getLogger(__name__)

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # grey, RGB, grey + alpha, RGBA


def _categories(rec: dict) -> set:
    return {a["category_id"] for a in rec.get("annotations", [])
            if a["category_id"] >= 0}


def repeat_factors_from_category_frequency(records: list[dict],
                                           repeat_thresh: float
                                           ) -> np.ndarray:
    """LVIS repeat factors: r(img) = max over its categories of
    max(1, sqrt(t / f_c)), f_c the fraction of images holding category c
    (reference build.py:166-211)."""
    counts: Counter = Counter()
    for rec in records:
        counts.update(_categories(rec))
    total = max(len(records), 1)
    freq = {c: n / total for c, n in counts.items()}
    rep = np.ones(len(records))
    for i, rec in enumerate(records):
        cats = _categories(rec)
        if cats:
            rep[i] = max(max(1.0, math.sqrt(repeat_thresh / freq[c]))
                         for c in cats)
    return rep


def dataset_balance_weights(sources: list) -> np.ndarray:
    """Per-image dataset-balancing weights (BALANCE_DATASETS, reference
    build.py:105-128): each source gets 1 - count / total, normalised so
    the largest source's weight is 1; one source is left unweighted.
    `sources` are the images' dataset sources (two splits of one dataset
    are one source), not the per-JSON dataset ids."""
    counts = Counter(sources)
    if len(counts) <= 1:
        return np.ones(len(sources))
    total = sum(counts.values())
    w = {d: 1.0 - c / total for d, c in counts.items()}
    mn = min(w.values())
    return np.array([w[d] / mn for d in sources])


def subsample_records(records: list[dict], percentage: float) -> list[dict]:
    """A seeded uniform TRAIN_SET_PERCENTAGE subsample in record order, not
    a prefix, which would drop whole sources (reference build.py:30-34,
    92-93)."""
    if percentage >= 1.0:
        return records
    keep = int(len(records) * percentage)
    idx = np.random.RandomState(42).permutation(len(records))[:keep]
    return [records[i] for i in np.sort(idx)]


def build_train_iterator(cfg: Config, records: list[dict], batch_size: int,
                         image_loader=None, max_gt: int = 64, seed: int = 0,
                         num_threads: int = 4, prefetch: int = 4
                         ) -> Iterator[dict]:
    """An endless weighted shuffle of fixed-shape training batches (numpy,
    the model's keyword names).

    Producer thread t draws batch indices from np.random.RandomState(seed +
    1 + 7919 t) with `choice(..., p=weights)` and maps each example with a
    RandomState seeded from that stream (flip, train scale), the JAX
    package's streams; the batches are taken from the threads in turn, so
    the sequence depends on the seed alone (with num_threads=1 it is the JAX
    iterator's). A data-parallel run gives each process its own seed (the
    train CLI adds the rank). Up to `prefetch` batches wait. A producer's
    error is raised by the iterator; closing it stops the producers."""
    records = subsample_records(records, cfg.input.train_set_percentage)
    if cfg.datasets.filter_empty_annotations:
        kept = [r for r in records
                if any(a.get("category_id", -1) >= 0
                       for a in r.get("annotations", []))]
        if len(kept) != len(records):
            logger.info("filtered %d empty-annotation images (%d left)",
                        len(records) - len(kept), len(kept))
        records = kept
    if not records:
        raise ValueError("no training record with a non-ignored annotation")

    weights = np.ones(len(records))
    if cfg.datasets.balance_datasets:
        weights *= dataset_balance_weights(
            [r.get("source", r.get("dataset_id", 0)) for r in records])
    if cfg.datasets.repeat_threshold > 0:
        weights *= repeat_factors_from_category_frequency(
            records, cfg.datasets.repeat_threshold)
    weights = weights / weights.sum()
    return _train_batches(cfg, records, weights, batch_size, image_loader,
                          max_gt, seed, num_threads, prefetch)


def _train_batches(cfg, records, weights, batch_size, image_loader, max_gt,
                   seed, num_threads, prefetch) -> Iterator[dict]:
    stop = threading.Event()
    outs = [queue.Queue(maxsize=max(1, -(-prefetch // num_threads)))
            for _ in range(num_threads)]

    def put(out: queue.Queue, item) -> None:
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer(tid: int) -> None:
        # One RandomState a thread: np.random.RandomState is not
        # thread-safe.
        local = np.random.RandomState(seed + 1 + tid * 7919)
        try:
            while not stop.is_set():
                idx = local.choice(len(records), size=batch_size, p=weights)
                examples = []
                for i in idx:
                    rng = np.random.RandomState(local.randint(2**31))
                    rec = records[i]
                    image = (image_loader(rec) if image_loader is not None
                             else None)
                    examples.append(map_example(rec, cfg, image=image,
                                                is_train=True, max_gt=max_gt,
                                                rng=rng))
                put(outs[tid], _to_model_batch(batch_examples(examples)))
        except Exception as e:              # raised again by the consumer
            put(outs[tid], e)

    threads = [threading.Thread(target=producer, args=(t,), daemon=True)
               for t in range(num_threads)]
    for t in threads:
        t.start()
    try:
        for i in itertools.count():
            item = outs[i % num_threads].get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def build_test_iterator(cfg: Config, records: list[dict], batch_size: int = 1,
                        image_loader=None, max_oracle: int = 64,
                        use_native: bool = True
                        ) -> Iterator[tuple[list[dict], dict]]:
    """Yields (records_chunk, batch) with the model's keyword names; the
    caller drops the padded slots by the chunk's length.

    With `use_native` on a machine with the cores for it
    (`native.native_worthwhile`), a chunk whose images all loaded resizes,
    pads and packs them in one call of the C++ batch path
    (`data/native.py`), the records' geometry mapped in Python with
    `skip_pixels`; a failed build of that library raises. Otherwise each
    image is resized by the mapper."""
    native_ok = use_native and native.native_worthwhile()
    S = cfg.model.backbone.square_pad
    for start in range(0, len(records), batch_size):
        chunk = records[start:start + batch_size]
        padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
        images = [image_loader(r) if image_loader is not None else None
                  for r in padded]
        if native_ok and all(im is not None for im in images):
            batch = batch_examples([
                map_example(r, cfg, is_train=False, max_oracle=max_oracle,
                            skip_pixels=True) for r in padded])
            batch["image"], batch["im_hw"], batch["im_scale_ratio"] = \
                native.preprocess_batch_native(
                    images, S, cfg.input.min_size_test,
                    cfg.input.max_size_test)
        else:
            batch = batch_examples([
                map_example(r, cfg, image=im, is_train=False,
                            max_oracle=max_oracle)
                for r, im in zip(padded, images)])
        yield chunk, _to_model_batch(batch)


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
        raise ValueError(f"{path}: {kind}; read_png reads 8-bit PNG only "
                         "(utils/util.py imread_rgb reads the others "
                         "through PIL)")
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


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 RGB as the bytes of an 8-bit RGB PNG (every scanline
    unfiltered), the format `read_png` reads."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    return (_PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def write_png(path, rgb: np.ndarray) -> None:
    """`encode_png` to a file: for writing images where cv2 is missing."""
    Path(path).write_bytes(encode_png(rgb))


def default_image_loader(data_root: str):
    """Loads record['file_name'] relative to data_root as RGB uint8
    (`utils/util.py` `imread_rgb`: PNG here, other formats through PIL);
    None for a missing file."""
    from ovmono3d_tpu_torch.utils.util import imread_rgb

    def load(rec: dict):
        path = Path(data_root) / rec["file_name"]
        if not path.exists():
            return None
        return imread_rgb(path)

    return load
