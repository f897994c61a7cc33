"""A minimal PNG encoder on ``zlib`` and ``struct``.

Writes 8-bit grayscale, RGB or RGBA images, unfiltered and unlaced, which
every decoder reads.  The serving path needs nothing more, and the port
needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}      # channels -> PNG color type


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(u8: np.ndarray) -> bytes:
    """[H, W] or [H, W, C] uint8 (C in 1, 3, 4) -> PNG bytes."""
    arr = np.asarray(u8)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes [H, W] or [H, W, 1|3|4], "
                         f"got shape {u8.shape}")
    h, w, c = arr.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    # each scanline starts with its filter type byte (0 = none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, w * c)], 1)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
