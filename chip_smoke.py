#!/usr/bin/env python3
"""Drive the PyTorch port of Season-NeRF on one NVIDIA GPU and report.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the render path from ``season_nerf_torch/csrc``
   (one ``nvcc`` per source, started together) and print what ``ptxas``
   reports (registers, shared memory, spills);
3. hold each kernel against its plain PyTorch version at the shapes of the
   flagship render chunk (width 512, fc1..fc8 + fc9, 5120 rays x 96
   samples) and at a ragged row count, in bf16 and f32 with the polynomial
   and the exact sine, with BatchNorm statistics that are not trivial;
   time the kernel and the plain version with CUDA events beside the
   kernel's bound;
4. write a full-width model directory (``Config()`` defaults, seeded random
   weights) with the port's own writer, load it onto the card, serve it
   over HTTP on an ephemeral localhost port and issue a fixed set of
   ``/healthz``, ``/render`` and ``/dsm`` requests; check statuses, that
   every body decodes, that the launch counts of the kernels match the
   chunking, and that a small render agrees with the CPU path (plain
   versions) on the same model directory; then time 10 warm 128 px
   renders from one client and profile one (device time by kernel, the
   device's idle share);
5. print one ``{"kernels": [...]}`` line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when no CUDA device is visible or the
port is not beside this script.  Every measurement also goes, as JSON, to
``--json PATH`` (default ``build/chip_smoke.json`` beside this script).
"""

from __future__ import annotations

import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_JSON = os.path.join(ROOT, "build", "chip_smoke.json")

# H100 SXM published peaks (NVIDIA data sheet, dense), used for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP_N = 5120 * 96          # points in one flagship render chunk
RAGGED_N = 4133                 # not a multiple of any tile
SEED = 0
STEADY_PATH = "/render?size=128"
STEADY_REQUESTS = 10
# profiled device time grouped by kind: the first kind whose marks occur
# in a kernel's name (lower case) takes it
KERNEL_KINDS = (("K3 trunk_infer", ("trunk_bf16", "trunk_f32")),
                ("GEMM", ("gemm", "cutlass", "nvjet")),
                ("copy/cast", ("copy",)),
                ("elementwise", ("elementwise",)))

# Kernel against plain version, max / mean absolute error on x_enc (values
# in [-1, 1]).  f32: the two differ only in the order of f32 accumulation
# (and, with the polynomial sine, in FMA contraction).  bf16: each layer
# rounds its activations to bf16 (ulp 2^-8 near 1), so an accumulation-order
# difference of ~1e-6 can flip one rounding, and the flip propagates through
# the later layers: the error grows with depth, to a few bf16 ulps at the
# flagship's nine layers (H100: max 5.0e-2, mean 6.6e-4 over 126 M values).
TOL = {torch.float32: (1e-3, 1e-5), torch.bfloat16: (1e-1, 2e-3)}
# a 16 px render on the card against the CPU path (plain versions) on the
# same model directory: bf16 colors and heights
RENDER_TOL = 5e-2


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# --- environment ------------------------------------------------------------
def import_port():
    """The port must come from this checkout, never from anywhere else."""
    sys.path.insert(0, ROOT)
    try:
        import season_nerf_torch
    except ImportError as e:
        fail(f"season_nerf_torch is not importable beside {__file__}: {e}")
    path = os.path.abspath(season_nerf_torch.__file__)
    if not path.startswith(os.path.join(ROOT, "season_nerf_torch") + os.sep):
        fail(f"season_nerf_torch comes from {path}, not from {ROOT}")
    for banned in ("jax", "flax", "season_nerf_tpu"):
        if banned in sys.modules:
            fail(f"{banned} was imported")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# --- the model --------------------------------------------------------------
@torch.no_grad()
def calibrate_bn_(gnerf, n_points: int = 4096, seed: int = SEED):
    """Give every trunk BatchNorm statistics that are not trivial: the
    running mean and (biased) variance of the layer's own pre-activation
    over random points in the cube, and a scale and shift drawn around 1
    and 0.  Runs in f32; the model lies on the CPU."""
    from season_nerf_torch.models.encodings import positional_encode
    from season_nerf_torch.ops.fused_trunk import PE_FREQS, trunk_layers
    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand(n_points, 3, generator=gen) * 2 - 1
    pe = positional_encode(pts, PE_FREQS)
    h = None
    for layer, kind in trunk_layers(gnerf):
        x = (pe if kind == "pe" else torch.cat([h, pe], 1)
             if kind == "h+pe" else h)
        z = layer.omega_0 * (x @ layer.linear.weight.t() + layer.linear.bias)
        if layer.norm is not None:
            n = layer.norm
            n.running_mean.copy_(z.mean(0))
            n.running_var.copy_(z.var(0, unbiased=False))
            n.weight.copy_(torch.rand(n.weight.shape, generator=gen) + 0.5)
            n.bias.copy_(0.2 * torch.randn(n.bias.shape, generator=gen))
            z = layer.bn_eval(z)
        h = torch.sin(z)


def make_model(cfg):
    """A seeded full-width model on the CPU, BN statistics calibrated."""
    from season_nerf_torch.models.tnerf import model_from_config
    torch.manual_seed(SEED)
    model = model_from_config(cfg)
    calibrate_bn_(model.G_NeRF_net)
    return model


def trunk_macs(gnerf) -> int:
    """Multiply-adds per point of the trunk, without the padding."""
    from season_nerf_torch.ops.fused_trunk import trunk_layers
    return sum(layer.linear.in_features * layer.linear.out_features
               for layer, _ in trunk_layers(gnerf))


# --- phase 3: kernels against their plain versions --------------------------
def check_trunk(model, device) -> dict:
    from season_nerf_torch.ops import fused_trunk as ft
    g = model.G_NeRF_net
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    results = {}
    macs = trunk_macs(g)
    for dtype in (torch.bfloat16, torch.float32):
        folded = ft.fold_trunk(g, dtype=dtype, device=device)
        for fast_sine in (True, False):
            name = (f"trunk_infer[{str(dtype).split('.')[-1]},"
                    f"{'fast_sin' if fast_sine else 'sinf'}]")
            for n in (FLAGSHIP_N, RAGGED_N):
                pts = torch.rand(n, 3, generator=gen, device=device) * 2 - 1
                pe = ft.encode_points(pts).contiguous()
                got = ft.trunk_apply(pe, folded, fast_sine)
                want = ft.trunk_apply_reference(pe, folded, fast_sine)
                torch.cuda.synchronize()
                if got.shape != want.shape or not torch.isfinite(got).all():
                    fail(f"{name} N={n}: shape {tuple(got.shape)} or "
                         f"non-finite output")
                err = (got - want).abs()
                max_err, mean_err = float(err.max()), float(err.mean())
                tol_max, tol_mean = TOL[dtype]
                rec = {"n": n, "max_abs_err": max_err,
                       "mean_abs_err": mean_err, "tol_max": tol_max,
                       "tol_mean": tol_mean}
                if n == FLAGSHIP_N:
                    reps = 10 if dtype == torch.bfloat16 else 3
                    rec["ms"] = cuda_ms(
                        lambda: ft.trunk_apply(pe, folded, fast_sine), reps)
                    rec["plain_ms"] = cuda_ms(
                        lambda: ft.trunk_apply_reference(pe, folded,
                                                         fast_sine), 2)
                    flops = 2.0 * macs * n
                    nbytes = (pe.numel() * 4 + got.numel() * 4
                              + sum(t.numel() * t.element_size()
                                    for t in folded.weights + folded.biases))
                    peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                            else PEAK_F32_FLOPS)
                    t_ops = flops / peak * 1e3
                    t_bytes = nbytes / PEAK_BYTES * 1e3
                    rec.update(flops=flops, bytes=nbytes,
                               bound_ms=max(t_ops, t_bytes),
                               bound_by="operations" if t_ops >= t_bytes
                               else "bytes")
                log(f"  {name} N={n}: max_abs_err {max_err:.3e} "
                    f"(tol {tol_max:g}), mean_abs_err {mean_err:.3e} "
                    f"(tol {tol_mean:g})"
                    + (f", kernel {rec['ms']:.3f} ms, plain "
                       f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f}"
                       f" ms ({rec['bound_by']})" if "ms" in rec else ""))
                results.setdefault(name, []).append(rec)
                if max_err > tol_max or mean_err > tol_mean:
                    fail(f"{name} N={n} disagrees with its plain version")
                del got, want, pe, pts
        del folded
    return results


def check_trunk_small_widths(device):
    """Every depth and width the model builds goes through the same kernel:
    a narrow, shallow trunk at a ragged row count."""
    from season_nerf_torch.config import Config
    from season_nerf_torch.ops import fused_trunk as ft
    for width, depth in ((32, 2), (128, 4), (96, 7)):
        model = make_model(Config(fc_units=width, fc_layers=depth)).to(device)
        gen = torch.Generator(device=device).manual_seed(SEED + width)
        pe = ft.encode_points(torch.rand(RAGGED_N, 3, generator=gen,
                                         device=device) * 2 - 1)
        for dtype in (torch.bfloat16, torch.float32):
            folded = ft.fold_trunk(model.G_NeRF_net, dtype=dtype)
            for fast_sine in (True, False):
                got = ft.trunk_apply(pe, folded, fast_sine)
                want = ft.trunk_apply_reference(pe, folded, fast_sine)
                err = float((got - want).abs().max())
                log(f"  width {width} depth {depth} {dtype} "
                    f"fast_sine={fast_sine}: max_abs_err {err:.3e}")
                if err > TOL[dtype][0]:
                    fail(f"trunk width {width} depth {depth} {dtype} "
                         f"fast_sine={fast_sine}: {err}")


# --- phase 4: the main path -------------------------------------------------
def decode_png(body: bytes) -> np.ndarray:
    """8-bit gray/RGB/RGBA PNG with unfiltered scanlines (what the port's
    encoder writes) -> uint8 array; checks every CRC."""
    if body[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(body):
        (length,) = struct.unpack(">I", body[pos:pos + 4])
        kind, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", body[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + length
    w, h, depth, ctype = hdr[0], hdr[1], hdr[2], hdr[3]
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    if depth != 8:
        raise ValueError(f"bit depth {depth}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    if raw[:, 0].any():
        raise ValueError("filtered scanlines")
    img = raw[:, 1:].reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img


def get(port: int, path: str):
    url = f"http://127.0.0.1:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=600) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def latency(port: int, path: str, n: int) -> dict:
    """``n`` back-to-back GETs of ``path`` from one client (a closed loop),
    after the main path has warmed the service; seconds per request."""
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        status, _, _ = get(port, path)
        secs.append(time.perf_counter() - t0)
        if status != 200:
            fail(f"GET {path}: HTTP {status}")
    size = int(path.split("size=")[1].split("&")[0])
    med = float(np.median(secs))
    return {"path": path, "n": n, "seconds": secs, "median_s": med,
            "min_s": min(secs), "max_s": max(secs),
            "rays_per_s": size * size / med}


def profile_render(renderer, size: int) -> dict:
    """One ``size`` px season render under ``torch.profiler``: device time
    by kernel, device busy time against the render's wall time."""
    from torch.profiler import ProfilerActivity, profile
    args = ((70.0, 30.0), (45.0, 180.0), 0.5, size)
    renderer.render_img(*args)                      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render_img(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    by_kind = {}
    for name, ms in top:
        kind = next((k for k, marks in KERNEL_KINDS
                     if any(m in name.lower() for m in marks)), "rest")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    return {"size": size, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": (1 - busy / (wall * 1e3)) if busy else None,
            "by_kind_ms": by_kind, "kernels_ms": dict(top)}


def main_path(model, cfg, device) -> dict:
    from season_nerf_torch.data.ingest import save_world_artifact
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    from season_nerf_torch.render.serving import RenderService, make_server
    from season_nerf_torch.train.state import save_model_artifact

    S, chunk = cfg.n_samples, cfg.chunk
    chunks = lambda n: -(-n // chunk)
    # (path, expected K3 launches, body kind, expected shape)
    requests = [
        ("/healthz", 0, "json", None),
        ("/render?size=128", chunks(128 * 128), "png", (128, 128, 3)),
        ("/render?size=64&layer=base", chunks(64 * 64), "png", (64, 64, 3)),
        ("/render?size=16&exact_shadow=1",
         chunks(16 * 16) + chunks(16 * 16 * S) * (S - 1), "png",
         (16, 16, 3)),
        ("/dsm?size=128", chunks(128 * 128), "npy", (128, 128)),
        ("/dsm?size=64&format=png", chunks(64 * 64), "png", (64, 64)),
    ]
    h_range = (0.0, 30.0)
    report = {"requests": []}
    with tempfile.TemporaryDirectory() as d:
        cfg.save_json(os.path.join(d, "opts.json"))
        save_model_artifact(os.path.join(d, "Final_Model.nn"),
                            model.state_dict(), meta={"seed": SEED})
        save_world_artifact(os.path.join(d, "W2C_W2L_H.npy"), None, None,
                            h_range)
        t0 = time.perf_counter()
        service = RenderService(d, device=device)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
        log(f"  model directory loaded onto {device} in "
            f"{report['load_s']:.3f} s")
        server = make_server(service, "127.0.0.1", 0)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            ft.trunk_apply.launches = 0
            for path, want_launches, kind, shape in requests:
                before = ft.trunk_apply.launches
                t0 = time.perf_counter()
                status, headers, body = get(port, path)
                secs = time.perf_counter() - t0
                launches = ft.trunk_apply.launches - before
                if status != 200:
                    fail(f"GET {path}: HTTP {status}: {body[:500]!r}")
                if kind == "json":
                    info = json.loads(body)
                    if info.get("status") != "ok":
                        fail(f"GET {path}: {info}")
                    arr = None
                elif kind == "png":
                    arr = decode_png(body)
                else:
                    arr = np.load(io.BytesIO(body))
                    if headers.get("X-DSM-Units") != "meters":
                        fail(f"GET {path}: units {headers.get('X-DSM-Units')}")
                if arr is not None:
                    if arr.shape != shape:
                        fail(f"GET {path}: shape {arr.shape}, want {shape}")
                    finite = np.isfinite(arr.astype(np.float64))
                    if kind == "npy":
                        vals = arr[finite]
                        lo, hi = h_range
                        if vals.size == 0 or vals.min() < lo - 1e-3 \
                                or vals.max() > hi + 1e-3:
                            fail(f"GET {path}: heights {vals.size} finite, "
                                 f"out of {h_range}")
                    elif not finite.all() or not arr.any():
                        fail(f"GET {path}: empty or non-finite image")
                if launches != want_launches:
                    fail(f"GET {path}: {launches} K3 launches, the chunking "
                         f"implies {want_launches}")
                rec = {"path": path, "status": status, "seconds": secs,
                       "bytes": len(body), "k3_launches": launches}
                report["requests"].append(rec)
                log(f"  GET {path}: {status}, {len(body)} B, {secs:.3f} s, "
                    f"K3 launches {launches}")
            report["k3_launches"] = ft.trunk_apply.launches
            report["latency"] = latency(port, STEADY_PATH, STEADY_REQUESTS)
            lat = report["latency"]
            log(f"  GET {STEADY_PATH} x {lat['n']}, one client: median "
                f"{lat['median_s']:.4f} s, min {lat['min_s']:.4f} s, max "
                f"{lat['max_s']:.4f} s ({lat['rays_per_s']:.0f} rays/s at "
                f"the median)")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)

        # the same small render on the card and on the CPU (plain versions)
        cpu = load_model_dir(d, device="cpu").renderer
        args = ((70.0, 30.0), (45.0, 180.0), 0.5, 16)
        a = service.renderer.render_img(*args)
        b = cpu.render_img(*args)
        diffs = {k: float(np.nanmax(np.abs(
            np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))))
            for k in ("Col_Img", "Shadow_Mask", "Height", "PS_Sum")}
        report["card_vs_cpu_16px"] = diffs
        log(f"  16 px render, card against CPU: {diffs} (tol {RENDER_TOL})")
        if not all(np.isfinite(v) and v <= RENDER_TOL for v in diffs.values()):
            fail("the card's render disagrees with the CPU path")

        prof = profile_render(service.renderer, 128)
        report["profile_128px"] = prof
        if prof["device_busy_ms"] == 0:
            log("  profiler: no device time traced (not measured)")
        else:
            log(f"  profiler, one 128 px render: wall {prof['wall_ms']:.2f}"
                f" ms, device busy {prof['device_busy_ms']:.2f} ms, idle "
                f"share {prof['idle_share']:.3f}; by kind:")
            for kind, ms in sorted(prof["by_kind_ms"].items(),
                                   key=lambda kv: -kv[1]):
                share = 100 * ms / prof["device_busy_ms"]
                log(f"    {ms:9.3f} ms  {share:5.1f} %  {kind}")
            log("  top kernels:")
            for name, ms in list(prof["kernels_ms"].items())[:8]:
                log(f"    {ms:9.3f} ms  {name[:100]}")
    return report


def main():
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", default=DEFAULT_JSON,
                   help="where to write every measurement as JSON")
    args = p.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    import_port()
    from season_nerf_torch.config import Config
    from season_nerf_torch.ops import cuda_build, fused_trunk as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda_build.build([ft.KERNEL])
    log(f"built {ft.KERNEL} in {time.perf_counter() - t0:.1f} s")
    ptxas = cuda_build.ptxas_report(ft.KERNEL)
    for line in ptxas.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            log(f"  ptxas: {line.strip()}")

    cfg = Config()
    model = make_model(cfg)
    log("K3 (trunk_infer) against trunk_apply_reference:")
    trunk = check_trunk(model.to(device), device)
    check_trunk_small_widths(device)

    log("main path: HTTP serving at full width")
    serving = main_path(model.cpu(), cfg, device)

    flagship = trunk["trunk_infer[bfloat16,fast_sin]"][0]
    kernels = [{
        "name": "trunk_infer",
        "route": "cuda",
        "source": "season_nerf_torch/csrc/trunk_infer.cu",
        "replaces": "season_nerf_tpu/ops/pallas_mlp.py:106",
        "launches": serving["k3_launches"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in trunk["trunk_infer[bfloat16,fast_sin]"]),
        "ms": flagship["ms"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": None,
    }]
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "ptxas": ptxas,
                   "trunk": trunk, "serving": serving, "kernels": kernels,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
