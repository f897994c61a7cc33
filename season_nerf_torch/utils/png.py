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


GAP = 4                                 # px of white between panels


def panel_grid(rows, gap: int = GAP) -> np.ndarray:
    """Rows of [H, W, 3] panels in [0, 1] (NaN as 0) -> one uint8 image:
    the panels of a row side by side, ``gap`` white pixels apart, top
    aligned on a white ground; the rows one under another, as far apart."""
    lines = []
    for panels in rows:
        h = max(p.shape[0] for p in panels)
        parts = []
        for i, p in enumerate(panels):
            p = np.clip(np.nan_to_num(np.asarray(p, float)), 0, 1)
            pad = np.ones((h, p.shape[1], 3))
            pad[:p.shape[0]] = p
            if i:
                parts.append(np.ones((h, gap, 3)))
            parts.append(pad)
        lines.append(np.concatenate(parts, 1))
    w = max(line.shape[1] for line in lines)
    out = []
    for i, line in enumerate(lines):
        if i:
            out.append(np.ones((gap, w, 3)))
        out.append(np.concatenate(
            [line, np.ones((line.shape[0], w - line.shape[1], 3))], 1))
    return (np.concatenate(out, 0) * 255 + 0.5).astype(np.uint8)


def write_panels(rows, path: str):
    """:func:`panel_grid` of ``rows`` written to ``path`` as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(panel_grid(rows)))
