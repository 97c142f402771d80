"""TensorBoard event files in pure Python (a copy of
ovmono3d_tpu/train/tb_writer.py; no TensorFlow or tensorboardX needed).

The reference's default_writers include a TensorBoard sink (detectron2's
TensorboardXWriter, reference tools/train_net.py:153). The event-file
format is small and stable, so it is written directly:

  * File: `events.out.tfevents.<unix_time>.<hostname>` in the log dir.
  * Records: TFRecord framing — little-endian uint64 payload length,
    masked CRC32C of those 8 length bytes, payload, masked CRC32C of the
    payload. Mask: ((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32.
  * Payload: an `Event` protobuf. We need only three shapes:
      - header event: wall_time (field 1, double) + file_version
        (field 3, string = "brain.Event:2")
      - scalar event: wall_time + step (field 2, varint int64) +
        summary (field 5) holding repeated Summary.Value (field 1),
        each with tag (field 1, string) + simple_value (field 2, float).
      - image event: same Event/Value framing, but the Value carries
        image (field 4) = Summary.Image{height(1), width(2),
        colorspace(3), encoded_image_string(4) = PNG bytes}.
    Hand-encoding these ~8 proto fields beats a protobuf/TF dependency.

CRC32C (Castagnoli) is implemented table-based in pure Python; it runs
once per flushed record, far off any hot path. Images are encoded with
data/build.py's `encode_png` (the machine with the card has no OpenCV).
"""
from __future__ import annotations

import functools
import socket
import struct
import time
from pathlib import Path

import numpy as np

from ovmono3d_tpu_torch.data.build import encode_png

# ---------------------------------------------------------------- crc32c


@functools.cache
def _crc_table() -> tuple[int, ...]:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _scalar_event(step: int, wall_time: float,
                  scalars: dict[str, float]) -> bytes:
    values = b"".join(
        _field_bytes(
            1,  # Summary.value
            _field_bytes(1, tag.encode()) + _field_float(2, float(v)),
        )
        for tag, v in scalars.items()
    )
    return (
        _field_double(1, wall_time)
        + _field_varint(2, step)
        + _field_bytes(5, values)  # Event.summary
    )


def _image_event(step: int, wall_time: float, tag: str, png: bytes,
                 height: int, width: int, colorspace: int = 3) -> bytes:
    """Event with one Summary.Value.image (field 4): Summary.Image holds
    height (1), width (2), colorspace (3: 1=gray, 3=RGB, 4=RGBA) and the
    PNG bytes (4) — what the reference's TensorboardXWriter emits for
    visualize_training panels (rcnn3d.py:119-250)."""
    image = (
        _field_varint(1, height)
        + _field_varint(2, width)
        + _field_varint(3, colorspace)
        + _field_bytes(4, png)
    )
    value = _field_bytes(1, tag.encode()) + _field_bytes(4, image)
    return (
        _field_double(1, wall_time)
        + _field_varint(2, step)
        + _field_bytes(5, _field_bytes(1, value))  # Event.summary
    )


def _header_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def _frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


# --------------------------------------------------------------- writer

class TBEventWriter:
    """Minimal `tf.summary.create_file_writer` replacement for scalars."""

    def __init__(self, logdir: str | Path):
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        name = f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
        self._f = open(logdir / name, "ab")
        self._f.write(_frame(_header_event(now)))
        self._f.flush()

    def add_scalars(self, step: int, scalars: dict[str, float]):
        if not scalars:
            return
        self._f.write(_frame(_scalar_event(step, time.time(), scalars)))

    def add_image(self, step: int, tag: str, rgb) -> None:
        """Log an HxWx3 uint8 RGB array as a TB image summary."""
        rgb = np.ascontiguousarray(rgb)
        if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
            raise ValueError(f"expected HxWx3 uint8, got {rgb.shape} "
                             f"{rgb.dtype}")
        h, w = rgb.shape[:2]
        self._f.write(_frame(
            _image_event(step, time.time(), tag, encode_png(rgb), h, w)
        ))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_events(path: str | Path):
    """Parse an event file back into (step, {tag: value}) tuples.

    Test/debug helper: verifies framing CRCs and decodes the same subset
    of the proto the writer emits (raises on corrupt records).
    """
    return [(step, scalars)
            for step, scalars, _ in read_events_full(path) if scalars]


def read_image_events(path: str | Path):
    """(step, {tag: {'height', 'width', 'colorspace', 'png'}}) tuples."""
    return [(step, images)
            for step, _, images in read_events_full(path) if images]


def read_events_full(path: str | Path):
    """All records as (step, scalars, images); verifies both CRCs."""
    out = []
    data = Path(path).read_bytes()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos:pos + 8]
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(header) != len_crc:
            raise ValueError(f"bad length crc at {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (data_crc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if _masked_crc(payload) != data_crc:
            raise ValueError(f"bad payload crc at {pos}")
        pos += 16 + length
        step, scalars, images = _parse_event(payload)
        out.append((step, scalars, images))
    return out


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return result, pos


def _parse_event(buf: bytes) -> tuple[int, dict[str, float], dict]:
    step, scalars, images = 0, {}, {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            if num == 2:
                step = val
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + length]
            pos += length
            if num == 5:  # summary
                sc, im = _parse_summary(sub)
                scalars.update(sc)
                images.update(im)
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return step, scalars, images


def _parse_image(buf: bytes) -> dict:
    out = {"height": 0, "width": 0, "colorspace": 0, "png": b""}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            if num == 1:
                out["height"] = val
            elif num == 2:
                out["width"] = val
            elif num == 3:
                out["colorspace"] = val
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            if num == 4:
                out["png"] = buf[pos:pos + length]
            pos += length
        else:
            raise ValueError(f"unsupported image wire type {wire}")
    return out


def _parse_summary(buf: bytes) -> tuple[dict[str, float], dict]:
    scalars, images = {}, {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire != 2 or num != 1:
            raise ValueError("unexpected summary field")
        length, pos = _read_varint(buf, pos)
        val = buf[pos:pos + length]
        pos += length
        tag, simple, image = None, None, None
        vpos = 0
        while vpos < len(val):
            vkey, vpos = _read_varint(val, vpos)
            vnum, vwire = vkey >> 3, vkey & 7
            if vwire == 2:
                vlen, vpos = _read_varint(val, vpos)
                if vnum == 1:
                    tag = val[vpos:vpos + vlen].decode()
                elif vnum == 4:
                    image = _parse_image(val[vpos:vpos + vlen])
                vpos += vlen
            elif vwire == 5:
                if vnum == 2:
                    (simple,) = struct.unpack_from("<f", val, vpos)
                vpos += 4
            elif vwire == 1:
                vpos += 8
            elif vwire == 0:
                _, vpos = _read_varint(val, vpos)
        if tag is not None and simple is not None:
            scalars[tag] = simple
        if tag is not None and image is not None:
            images[tag] = image
    return scalars, images
