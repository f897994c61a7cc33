"""Metric logging: TensorBoard event files and JSON lines (``metrics.jsonl``).

The counterpart of ``season_nerf_tpu/utils/logging.py``'s ``MetricWriter``,
with its signature, tags (``Training/<name>``, ``Testing/<name>``) and
record keys.  The JAX writer goes through ``torch.utils.tensorboard``'s
``SummaryWriter``, which needs the ``tensorboard`` package; the port writes
the event file itself (:class:`EventFile`):

- ``events.out.tfevents.<time>.<host>.<pid>.<n>`` in ``logdir``, opening
  with a ``file_version: "brain.Event:2"`` event;
- records framed as TFRecords: the length (uint64), its masked CRC-32C,
  the data, the data's masked CRC-32C;
- ``Event`` and ``Summary`` protobufs encoded by hand: ``simple_value`` for
  a scalar, ``Summary.Image`` with a PNG (``utils/png.py``) for an image,
  whose pixels are ``SummaryWriter.add_image``'s (in float32, x 255,
  clipped to [0, 255] and truncated; one channel as three).

An empty ``logdir`` makes a writer that writes nothing; with
``use_tensorboard=False`` it writes the JSON lines alone.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from itertools import count
from typing import Dict

import numpy as np

from season_nerf_torch.utils.png import encode_png


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, the data's."""
    n = struct.pack("<Q", len(data))
    return (n + struct.pack("<I", masked_crc32c(n)) + data
            + struct.pack("<I", masked_crc32c(data)))


# --- protobuf wire format, the few fields an event needs ----------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _bytes(number: int, data: bytes) -> bytes:
    return _field(number, 2) + _varint(len(data)) + data


def _int(number: int, value: int) -> bytes:
    return _field(number, 0) + _varint(value) if value else b""


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary_value: bytes = b"") -> bytes:
    """tensorboard's ``Event``: wall_time (1, double), step (2), file_version
    (3) or summary (5) holding one ``Summary.Value`` (1)."""
    out = _field(1, 1) + struct.pack("<d", wall_time) + _int(2, step)
    if file_version:
        out += _bytes(3, file_version.encode())
    if summary_value:
        out += _bytes(5, _bytes(1, summary_value))
    return out


def scalar_value(tag: str, value: float) -> bytes:
    """``Summary.Value``: tag (1), simple_value (2, float32)."""
    return _bytes(1, tag.encode()) + _field(2, 5) + struct.pack("<f", value)


def image_value(tag: str, u8: np.ndarray) -> bytes:
    """``Summary.Value``: tag (1), image (4) = ``Summary.Image``: height
    (1), width (2), colorspace (3), the PNG (4)."""
    h, w, c = u8.shape
    image = (_int(1, h) + _int(2, w) + _int(3, c)
             + _bytes(4, encode_png(u8)))
    return _bytes(1, tag.encode()) + _bytes(4, image)


def summary_pixels(img) -> np.ndarray:
    """[H, W, C] or [H, W] in [0, 1] -> the [H, W, 3 or 4] uint8 pixels the
    JAX writer's ``add_image`` stores (clip to [0, 1], one channel as
    three, x 255 in float32, clip, truncate)."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    arr = np.clip(arr, 0, 1)
    if arr.shape[2] == 1:
        arr = np.concatenate([arr, arr, arr], 2)
    scale = 1 if arr.dtype == np.uint8 else 255
    return (arr.astype(np.float32) * scale).clip(0, 255).astype(np.uint8)


_FILE_NUMBER = count()


class EventFile:
    """A TensorBoard event file in ``logdir``, written record by record."""

    def __init__(self, logdir: str):
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}.{os.getpid()}.{next(_FILE_NUMBER)}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        self._f.write(tfrecord(_event(time.time(),
                                      file_version="brain.Event:2")))

    def add(self, summary_value: bytes, step: int):
        self._f.write(tfrecord(_event(time.time(), int(step),
                                      summary_value=summary_value)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class MetricWriter:
    """Writes scalars to TensorBoard and JSON lines, images to TensorBoard.
    An empty or None ``logdir`` makes a writer that writes nothing."""

    def __init__(self, logdir: str, use_tensorboard: bool = True):
        self.logdir = logdir
        self._jsonl = None
        self._tb = None
        if not logdir:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if use_tensorboard:
            self._tb = EventFile(logdir)

    def scalar(self, tag: str, value, step: int):
        if self._jsonl is None:
            return
        v = float(value)
        if self._tb is not None:
            self._tb.add(scalar_value(tag, v), step)
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag,
                                      "value": v, "step": int(step)}) + "\n")

    def scalars(self, prefix: str, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def image(self, tag: str, img, step: int):
        """img: [H, W, C] float in [0, 1] or [H, W]; TensorBoard only."""
        if self._tb is not None:
            self._tb.add(image_value(tag, summary_pixels(img)), step)

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
