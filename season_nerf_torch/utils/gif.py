"""A minimal animated-GIF (GIF89a) encoder on numpy.

Each frame gets its own 256-entry palette (its exact colours where it has
at most 256, else a median cut refined by a few k-means passes), is
LZW-coded with 8-bit pixels (a clear code whenever the 4096-entry table
fills) and shown for ``delay_cs`` hundredths of a second; the NETSCAPE2.0
block makes the animation loop ``loop`` times (0: forever).  The
evaluation's walk animations need nothing more, and the port needs no
imaging package.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

_COLORS = 256
_KMEANS_PASSES = 2
_MAX_CODE = 4096


def _nearest(pixels: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Index of the nearest palette colour of each [N, 3] pixel."""
    pixels, palette = pixels.astype(np.float32), palette.astype(np.float32)
    out = np.empty(pixels.shape[0], np.int64)
    p2 = (palette ** 2).sum(1)
    for s in range(0, pixels.shape[0], 16384):
        x = pixels[s:s + 16384]
        out[s:s + 16384] = np.argmin(p2[None] - 2 * x @ palette.T, axis=1)
    return out


def _median_cut(pixels: np.ndarray, n: int) -> np.ndarray:
    """Split the colour box of most pixels times widest range at the median
    of that range's channel until there are ``n`` boxes -> their means."""
    def score(b):
        return b.shape[0] * np.ptp(b, 0).max() if b.shape[0] > 1 else -1.0

    boxes = [pixels]
    scores = [score(pixels)]
    while len(boxes) < n:
        i = int(np.argmax(scores))
        if scores[i] <= 0:
            break
        b = boxes.pop(i)
        scores.pop(i)
        ch = int(np.argmax(np.ptp(b, 0)))
        order = np.argsort(b[:, ch], kind="stable")
        half = b.shape[0] // 2
        for part in (b[order[:half]], b[order[half:]]):
            boxes.append(part)
            scores.append(score(part))
    return np.stack([b.mean(0) for b in boxes])


def quantize(frame: np.ndarray):
    """[H, W, 3] uint8 -> (palette [256, 3] uint8, indices [H, W] uint8)."""
    pixels = frame.reshape(-1, 3)
    colors, inverse = np.unique(pixels, axis=0, return_inverse=True)
    if colors.shape[0] <= _COLORS:
        palette = np.zeros((_COLORS, 3), np.uint8)
        palette[:colors.shape[0]] = colors
        return palette, inverse.reshape(frame.shape[:2]).astype(np.uint8)
    x = pixels.astype(np.float64)
    centres = _median_cut(x, _COLORS)
    for _ in range(_KMEANS_PASSES):
        idx = _nearest(x, centres)
        count = np.bincount(idx, minlength=centres.shape[0])
        sums = np.stack([np.bincount(idx, weights=x[:, c],
                                     minlength=centres.shape[0])
                         for c in range(3)], 1)
        live = count > 0
        centres[live] = sums[live] / count[live, None]
    palette = np.zeros((_COLORS, 3), np.uint8)
    palette[:centres.shape[0]] = np.clip(np.rint(centres), 0, 255)
    idx = _nearest(x, palette[:centres.shape[0]].astype(np.float64))
    return palette, idx.reshape(frame.shape[:2]).astype(np.uint8)


def lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a stream of pixel indices: codes of
    ``min_code_size + 1`` bits upward, widened as the table grows, packed
    least significant bit first; a clear code first, another each time
    the table holds 4096 codes, the end code last."""
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    data = np.asarray(indices, np.uint8).ravel().tolist()
    width = min_code_size + 1
    table, next_code = {}, end + 1
    emit(clear, width)
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        if next_code < _MAX_CODE:
            table[key] = next_code
            if next_code == 1 << width:
                width += 1
            next_code += 1
        else:
            emit(clear, width)
            table, next_code, width = {}, end + 1, min_code_size + 1
        prefix = k
    emit(prefix, width)
    emit(end, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[s:s + 255])]) + data[s:s + 255]
             for s in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def encode_gif(frames: Sequence[np.ndarray], delay_cs: int = 20,
               loop: int = 0) -> bytes:
    """[H, W, 3] uint8 frames of one size -> GIF89a bytes."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("encode_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"encode_gif takes [{h}, {w}, 3] uint8 frames, "
                             f"got {f.dtype} {f.shape}")
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
           + struct.pack("<H", loop) + b"\x00"]
    for f in frames:
        palette, idx = quantize(f)
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs)
                + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),
                palette.tobytes(), b"\x08", _sub_blocks(lzw_encode(idx))]
    out.append(b"\x3b")
    return b"".join(out)
