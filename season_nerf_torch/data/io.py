"""File IO of DFC2019-format sites: TIFF rasters, RPCs and IMD metadata.

The counterpart of ``season_nerf_tpu/data/io.py``, with a TIFF reader of its
own (numpy + ``struct`` + ``zlib``) in place of PIL:

- :func:`read_tiff`: the first image of a TIFF as float32 [H, W] or [H, W,
  C]; -9999 (the DSMs' no-data) becomes NaN in 2-D rasters.  Scaling 8-bit
  colors to [0, 1] is the caller's (``data/ingest.py``);
- :func:`rpc_from_tiff`: the RPCCoefficient tag (50844, 92 doubles) as an
  :class:`RPCModel`;
- :func:`parse_imd`: the WorldView IMD fields the pipeline reads;
- :func:`find_site_images` and :func:`load_rpc_for_image`: the site's
  ``<SITE>_<id>_RGB.tif`` files and each one's RPC (corrected ``.ikono``,
  then original ``.ikono``, then the GeoTIFF tag).

The reader takes byte orders II and MM, strips and tiles, no compression,
PackBits, Deflate and LZW (with or without the horizontal predictor on
integer samples), 8- and 16-bit unsigned and 32-bit float samples in chunky
planar configuration.  Anything else (BigTIFF, planar configuration 2,
JPEG, palette images, other sample types) raises ``ValueError`` naming the
tag, rather than returning wrong pixels.  16-bit samples come out at their
values (PIL narrows 16-bit RGB to 8 bits).
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Dict, Optional

import numpy as np

from season_nerf_torch.geometry.rpc import RPCModel, parse_rpc_file

RPC_TIFF_TAG = 50844

# TIFF field types -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8)}

_NONE, _LZW, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS = 1, 5, 32946, 8, 32773


def _read_ifd(data: bytes):
    """-> (byte order '<' or '>', {tag: tuple of values or bytes}) of the
    first image file directory."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None:
        raise ValueError("not a TIFF file (byte order mark)")
    (magic,) = struct.unpack(order + "H", data[2:4])
    if magic == 43:
        raise ValueError("BigTIFF (version 43) is not supported")
    if magic != 42:
        raise ValueError(f"not a TIFF file (version {magic})")
    (pos,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[pos:pos + 2])
    tags = {}
    for i in range(n):
        e = pos + 2 + 12 * i
        tag, typ, count = struct.unpack(order + "HHI", data[e:e + 8])
        if typ not in _TYPES:
            continue                    # a type this reader never needs
        code, size = _TYPES[typ]
        nbytes = size * count
        if nbytes <= 4:
            raw = data[e + 8:e + 8 + nbytes]
        else:
            (off,) = struct.unpack(order + "I", data[e + 8:e + 12])
            raw = data[off:off + nbytes]
        if typ in (2, 7):
            tags[tag] = raw
        else:
            tags[tag] = struct.unpack(order + code * count, raw)
    return order, tags


def _packbits_decode(buf: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(buf)
    while i < n:
        h = buf[i]
        i += 1
        if h < 128:                     # h + 1 literal bytes
            out += buf[i:i + h + 1]
            i += h + 1
        elif h > 128:                   # the next byte 257 - h times
            out += buf[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _lzw_decode(buf: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, clear 256, end 257, the
    code width growing one code early (at 511, 1023, 2047)."""
    if buf[:2] == b"\x00\x01":
        raise ValueError("TIFF tag 259 (Compression): old-style LZW is not "
                         "supported")
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, bitbuf, nbits, prev = 9, 0, 0, None
    for byte in buf:
        bitbuf = (bitbuf << 8) | byte
        nbits += 8
        while nbits >= width:
            nbits -= width
            code = (bitbuf >> nbits) & ((1 << width) - 1)
            if code == 257:
                return bytes(out)
            if code == 256:
                del table[258:]
                width, prev = 9, None
                continue
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("corrupt LZW data (code out of range)")
            out += entry
            prev = entry
            if len(table) + 1 >= (1 << width) and width < 12:
                width += 1
        bitbuf &= (1 << nbits) - 1
    return bytes(out)


def _decompress(buf: bytes, compression: int) -> bytes:
    if compression == _NONE:
        return buf
    if compression in (_DEFLATE, _ADOBE_DEFLATE):
        return zlib.decompress(buf)
    if compression == _LZW:
        return _lzw_decode(buf)
    if compression == _PACKBITS:
        return _packbits_decode(buf)
    raise ValueError(f"TIFF tag 259 (Compression) = {compression} is not "
                     "supported (none, LZW, Deflate or PackBits)")


def _sample_dtype(tags, order) -> np.dtype:
    bits = set(tags.get(258, (1,)))
    fmt = set(tags.get(339, (1,)))
    if len(bits) != 1 or len(fmt) != 1:
        raise ValueError("TIFF tags 258/339: mixed sample types")
    bits, fmt = bits.pop(), fmt.pop()
    kind = {(8, 1): "u1", (16, 1): "u2", (32, 3): "f4"}.get((bits, fmt))
    if kind is None:
        raise ValueError(f"TIFF tags 258/339 (BitsPerSample {bits}, "
                         f"SampleFormat {fmt}): only 8- and 16-bit unsigned "
                         "and 32-bit float samples are supported")
    return np.dtype(order + kind)


def _decode_block(buf, compression, predictor, dtype, rows, width, spp):
    """One strip or tile -> [rows, width, spp] samples."""
    raw = _decompress(buf, compression)
    need = rows * width * spp * dtype.itemsize
    if len(raw) < need:
        raise ValueError(f"TIFF strip or tile holds {len(raw)} bytes after "
                         f"decompression, {need} needed")
    block = np.frombuffer(raw[:need], dtype).reshape(rows, width, spp)
    if predictor == 2:
        native = block.astype(dtype.newbyteorder("="))
        block = np.cumsum(native, axis=1, dtype=native.dtype)
    return block


def _read_image(data: bytes) -> np.ndarray:
    order, tags = _read_ifd(data)
    width, height = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    compression = tags.get(259, (1,))[0]
    predictor = tags.get(317, (1,))[0]
    if tags.get(284, (1,))[0] != 1:
        raise ValueError("TIFF tag 284 (PlanarConfiguration) = 2 is not "
                         "supported")
    photometric = tags.get(262, (1,))[0]
    if photometric not in (1, 2):
        raise ValueError(f"TIFF tag 262 (PhotometricInterpretation) = "
                         f"{photometric} is not supported (1 or 2)")
    if tags.get(266, (1,))[0] != 1:
        raise ValueError("TIFF tag 266 (FillOrder) = 2 is not supported")
    dtype = _sample_dtype(tags, order)
    if predictor not in (1, 2) or (predictor == 2 and dtype.kind == "f"):
        raise ValueError(f"TIFF tag 317 (Predictor) = {predictor} is not "
                         "supported for these samples")

    out = np.empty((height, width, spp), dtype.newbyteorder("="))
    if 322 in tags:                                       # tiles
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        across = -(-width // tw)
        for i, (off, cnt) in enumerate(zip(offsets, counts)):
            r0, c0 = (i // across) * th, (i % across) * tw
            if r0 >= height:
                break
            block = _decode_block(data[off:off + cnt], compression,
                                  predictor, dtype, th, tw, spp)
            rr, cc = min(th, height - r0), min(tw, width - c0)
            out[r0:r0 + rr, c0:c0 + cc] = block[:rr, :cc]
    else:                                                 # strips
        per = min(tags.get(278, (height,))[0], height)
        for i, (off, cnt) in enumerate(zip(tags[273], tags[279])):
            r0 = i * per
            if r0 >= height:
                break
            rows = min(per, height - r0)
            out[r0:r0 + rows] = _decode_block(data[off:off + cnt],
                                              compression, predictor, dtype,
                                              rows, width, spp)
    return out[..., 0] if spp == 1 else out


def read_tiff(path: str, nodata_to_nan: bool = True) -> np.ndarray:
    """Read a TIFF into float32 [H, W] or [H, W, C]."""
    with open(path, "rb") as f:
        arr = _read_image(f.read()).astype(np.float32)
    if nodata_to_nan and arr.ndim == 2:
        arr[arr == -9999.0] = np.nan
    return arr


def rpc_from_tiff(path: str) -> Optional[RPCModel]:
    """The RPC model of TIFF tag 50844, or None without one."""
    with open(path, "rb") as f:
        _, tags = _read_ifd(f.read())
    vals = tags.get(RPC_TIFF_TAG)
    if vals is None:
        return None
    v = np.asarray(vals, np.float64)
    if v.size != 92:
        return None
    return RPCModel(
        row_offset=v[2], col_offset=v[3],
        lat_offset=v[4], lon_offset=v[5], alt_offset=v[6],
        row_scale=v[7], col_scale=v[8],
        lat_scale=v[9], lon_scale=v[10], alt_scale=v[11],
        row_num=v[12:32], row_den=v[32:52],
        col_num=v[52:72], col_den=v[72:92])


def parse_imd(path_or_text: str) -> Dict:
    """The IMD fields the pipeline needs -> {sun_el, sun_az, off_nadir,
    view_az (degrees), first_line_time (ISO UTC string)}, as found."""
    if os.path.exists(str(path_or_text)):
        with open(path_or_text, "r") as fin:
            text = fin.read()
    else:
        text = str(path_or_text)
    out = {}
    patterns = {
        "sun_az": r"meanSunAz\s*=\s*([-\d.]+)",
        "sun_el": r"meanSunEl\s*=\s*([-\d.]+)",
        "off_nadir": r"meanOffNadirViewAngle\s*=\s*([-\d.]+)",
        "view_az": r"meanSatAz\s*=\s*([-\d.]+)",
    }
    for k, pat in patterns.items():
        m = re.search(pat, text)
        if m:
            out[k] = float(m.group(1))
    m = re.search(r"firstLineTime\s*=\s*([\w\-.:]+)", text)
    if m:
        out["first_line_time"] = m.group(1).rstrip(";")
    return out


def find_site_images(root_dir: str, site_name: str):
    """-> [(name, path)] of ``<SITE>_<id>_RGB.tif`` under ``root_dir/Images``
    (or ``root_dir`` itself), sorted by name."""
    img_dir = os.path.join(root_dir, "Images")
    if not os.path.isdir(img_dir):
        img_dir = root_dir
    names = sorted(f for f in os.listdir(img_dir)
                   if f.startswith(site_name) and f.endswith("_RGB.tif"))
    return [(f[:-len(".tif")], os.path.join(img_dir, f)) for f in names]


def load_rpc_for_image(img_name: str, tif_path: str, cache_dir: str,
                       prefer_corrected: bool = True) -> RPCModel:
    """The image's RPC: the corrected ``.ikono`` in the cache, then the
    original ``.ikono``, then the GeoTIFF's tag."""
    candidates = []
    if prefer_corrected:
        candidates.append(os.path.join(cache_dir,
                                       f"rpc_{img_name}_corrected.ikono"))
    candidates.append(os.path.join(cache_dir,
                                   f"rpc_{img_name}_original.ikono"))
    for c in candidates:
        if os.path.exists(c):
            return parse_rpc_file(c)
    rpc = rpc_from_tiff(tif_path)
    if rpc is None:
        raise FileNotFoundError(
            f"no RPC for {img_name}: no .ikono in {cache_dir} and no RPC "
            "tag in the GeoTIFF")
    return rpc
