"""What the render cells share: a model directory of the benchmark's
weights served or rendered by the port, and the comparison of the frames
the timed path produced with the plain reference's."""

from __future__ import annotations

import struct
import tempfile
import zlib

import numpy as np

from portbench import bench, inputs, program

def model_dir(run) -> str:
    """A model directory of the benchmark's weights under ``TMPDIR``,
    written by the port's writers; a configuration with ``legacy_opts``
    leaves ``compute_dtype`` and ``fast_sine`` out of opts.json, as every
    directory written before those keys existed."""
    c = run.config
    cfg = program.port_config(c, seed=0)
    weights = inputs.make_weights(program.state_shapes(cfg), run.seed,
                                  run.device)
    d = tempfile.mkdtemp(prefix="portbench-model-")
    run.cleanup.append(d)
    program.write_model_dir(d, cfg, weights, drop=(
        ("compute_dtype", "fast_sine") if c.get("legacy_opts") else ()))
    run.inputs = {"weights": weights}
    return d


def sample(run, done: list, k: int) -> list:
    """``k`` of the indices ``done``, drawn from the seed, the largest
    frames first among equals."""
    rng = np.random.default_rng(inputs.entropy(run.seed, 6))
    pick = rng.permutation(len(done))[:k]
    return sorted((done[i] for i in pick), key=lambda i: -run.frames[i]
                  ["size"])


def reference_colours(run, idx: list, precision: str) -> dict:
    """The reference's colour of each frame ``idx`` of ``run.frames``."""
    from portbench.reference.model import Net, state_from, strict_f32
    from portbench.reference.render import render_colour
    c = run.config
    net = Net(state_from(run.inputs["weights"], run.device),
              n_layers=c["fc_layers"], precision=precision)
    out = {}
    with strict_f32(tf32=precision == "tf32"):
        for i in idx:
            f = run.frames[i]
            out[i] = render_colour(net, f["view"], f["sun"], f["year"],
                                   f["size"], c["n_samples"], run.device)
    return out


def to_u8(img: np.ndarray) -> np.ndarray:
    """A colour frame as the service encodes it: no data as 0, [0, 1]
    clipped, x 255 truncated."""
    return (np.clip(np.nan_to_num(img, nan=0.0), 0, 1) * 255).astype(
        np.uint8)


def decode_png(body: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG (any filter) -> [H, W, C] uint8."""
    if body[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    at, idat, hdr = 8, b"", None
    while at < len(body):
        n, kind = struct.unpack(">I4s", body[at:at + 8])
        data = body[at + 8:at + 8 + n]
        at += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace:
        raise ValueError(f"PNG depth {depth}, interlace {interlace}")
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    out = np.zeros((h, w * ch), np.int32)
    for r in range(h):
        f, line = raw[r, 0], raw[r, 1:].astype(np.int32)
        prev = out[r - 1] if r else np.zeros(w * ch, np.int32)
        if f == 0:
            out[r] = line
        elif f == 2:
            out[r] = (line + prev) % 256
        else:
            cur = np.zeros(w * ch, np.int32)
            for x in range(w * ch):
                a = cur[x - ch] if x >= ch else 0
                b, cc = prev[x], prev[x - ch] if x >= ch else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else \
                        b if pb <= pc else cc
                cur[x] = (line[x] + pred) % 256
            out[r] = cur
    return out.astype(np.uint8).reshape(h, w, ch)


def gaps(got: dict, want: dict) -> dict:
    """The largest absolute difference of any pixel, the worst frame's
    mean and the mean over the frames of each frame's mean."""
    d = [np.abs(np.asarray(got[i], np.float64) - np.asarray(w, np.float64))
         for i, w in want.items()]
    return {"frame_max_gap": max(float(x.max()) for x in d),
            "frame_mean_gap": max(float(x.mean()) for x in d),
            "frames_mean_gap": float(np.mean([x.mean() for x in d]))}


def check(run, modes, encode=lambda img: img) -> dict:
    """-> {mode: numbers}: the frames the program produced ("program") or
    the reference's at another precision in its place, against the
    float32 reference's, each through ``encode`` (the served format)."""
    idx = sample(run, sorted(run.outputs), run.traffic["checked"])
    want = {i: encode(v) for i, v in
            reference_colours(run, idx, "f32").items()}
    dt, out = run.config["compute_dtype"], {}
    for m in modes:
        got = run.outputs if m == "program" else {
            i: encode(v) for i, v in reference_colours(
                run, idx, bench.PRECISION[m][dt]).items()}
        out[m] = gaps(got, want)
    return out
