"""Independent viewers sharing one model: ``GET /render`` to the port's
``RenderService`` over ``ThreadingHTTPServer`` on an ephemeral localhost
port, sent on an open-loop schedule by a process of its own
(``loadgen.py``).

Each request's latency runs from when it was due, not from when it was
sent.  The arrivals are one draw of a Poisson process at ``rate`` a
second over the window, and the sizes one shuffle of equal shares, both
fixed by the mix's ``schedule_seed``: every run seed gets the same
schedule and the same work, and draws what each frame shows (view, sun,
time of year) and the weights.  Near the knee a queue's tail swings with
the order of its arrivals; with the order fixed, runs differ by what the
program does and not by the schedule.

Parameters of the mix: ``rate`` (requests a second), ``sizes`` (px, in
equal shares), ``layer``, the ranges ``view_el``, ``view_az``,
``sun_el``, ``sun_az`` in degrees, ``schedule_seed``, ``grace`` (seconds
a request may still take after the last is due) and ``checked`` (frames
the reference renders after the window).
"""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

from portbench import frames, inputs, program

LOADGEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "loadgen.py")
# the mix at a CPU test's size, and the window of a control run on the card
SMALL = {"rate": 4.0, "sizes": [8, 16], "checked": 4}
CONTROL_SECONDS = 8.0


def _path(f: dict, layer: str) -> str:
    return (f"/render?size={f['size']}&layer={layer}"
            f"&view_el={f['view'][0]!r}&view_az={f['view'][1]!r}"
            f"&sun_el={f['sun'][0]!r}&sun_az={f['sun'][1]!r}"
            f"&t={f['year']!r}")


def schedule(run):
    """-> (due times in seconds from the window's start, sizes) of the
    window's requests: ``schedule_seed``'s Poisson arrivals, scaled to
    span the window, and its shuffle of the sizes."""
    t = run.traffic
    sizes = list(t["sizes"])
    n = int(round(t["rate"] * run.seconds)) // len(sizes) * len(sizes)
    rng = np.random.default_rng(t["schedule_seed"])
    gaps = rng.exponential(1.0, n + 1)
    due = np.cumsum(gaps)[:n] / gaps.sum() * run.seconds
    return list(due), list(rng.permutation(sizes * (n // len(sizes))))


def setup(run):
    from season_nerf_torch.render.serving import RenderService, make_server
    t = run.traffic
    d = frames.model_dir(run)
    run.mark("model directory written")
    service = RenderService(d, device=str(run.device))
    run.mark("model directory loaded")
    renderer = service.renderer
    render, run.render_spans = renderer.render_img, {}

    def timed(view, sun, year, size, **kw):
        t0 = time.perf_counter()
        with run.spans("render_img"):
            out = render(view, sun, year, size, **kw)
        run.render_spans[(tuple(view), tuple(sun), year, size)] = (
            t0, time.perf_counter())
        return out

    renderer.render_img = timed
    run.faults.get("render", lambda r: None)(renderer)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    run.stops.append(lambda: (server.shutdown(), server.server_close(),
                              thread.join(timeout=60)))
    run.url = f"http://127.0.0.1:{server.server_address[1]}"
    run.program = service
    run.due, sizes = schedule(run)
    run.frames = inputs.frame_requests(run.seed, sizes, t)
    first = run.frames[0]
    for size in t["sizes"]:                   # warm each size once
        warm = dict(first, size=size, year=(first["year"] + 0.5) % 1.0)
        with urllib.request.urlopen(run.url + _path(warm, t["layer"]),
                                    timeout=600) as r:
            if r.status != 200:
                raise RuntimeError(f"warm-up request: HTTP {r.status}")


def window(run):
    t = run.traffic
    plan = {"url": run.url, "grace": t["grace"],
            "requests": [{"due": d, "path": _path(f, t["layer"])}
                         for d, f in zip(run.due, run.frames)]}
    gen = subprocess.Popen([sys.executable, LOADGEN], stdin=subprocess.PIPE,
                           stdout=subprocess.PIPE, text=True)
    run.children.append(gen)
    plan["start"] = time.monotonic() + 1.0
    offset = time.perf_counter() - time.monotonic()
    out, _ = gen.communicate(json.dumps(plan),
                             timeout=run.seconds + t["grace"] + 60)
    res = json.loads(out)
    start = plan["start"] + offset
    end = max([r["done"] + offset for r in res if r] + [start])
    run.window_span = (start, end)
    lat, late, run.outputs, queue = [], [], {}, []
    for i, r in enumerate(res):
        ok = r is not None and r["status"] == 200
        if ok:
            try:
                run.outputs[i] = frames.decode_png(base64.b64decode(
                    r["body"]))[..., :3]
            except (ValueError, KeyError):
                ok = False
        lat.append(r["done"] - r["due"] if ok else float("inf"))
        if r is not None:
            late.append(r["sent"] - r["due"])
        f = run.frames[i]
        span = run.render_spans.get((f["view"], f["sun"], f["year"],
                                     f["size"]))
        if ok and span:
            queue.append(lat[-1] - (span[1] - span[0]))
    run.attempted, run.failed = len(res), len(res) - len(run.outputs)
    print(f"load generator: {len(res)} requests due over {run.seconds} s; "
          f"sent late by p50 {np.median(late) * 1e3:.3f} ms, max "
          f"{max(late) * 1e3:.3f} ms", file=sys.stderr)
    spans = {}
    for key, (a, b) in run.render_spans.items():
        if start <= a < end:
            spans.setdefault(key[3], []).append(b - a)
    print("render spans: " + ", ".join(
        f"{s} px median {np.median(v) * 1e3:.3f} ms of {len(v)}"
        for s, v in sorted(spans.items())), file=sys.stderr)
    done = sorted(run.outputs)
    run.work = {"frames": [run.frames[i]["size"] ** 2 for i in done],
                "rays": sum(run.frames[i]["size"] ** 2 for i in done),
                "queue_s": queue,
                "render_spans": [run.render_spans[k] for k in
                                 sorted(run.render_spans)
                                 if start <= run.render_spans[k][0] < end],
                "wall_s": end - start, "latency_s": lat,
                "due_s": list(run.due)}
    run.end_to_end["frame_p50_s"] = (float(np.percentile(lat, 50)), "s")
    run.end_to_end["frame_p90_s"] = (float(np.percentile(lat, 90)), "s")


def release(run):
    for stop in run.stops:
        stop()
    run.stops.clear()
    program.free(run)


def check(run, modes) -> dict:
    return frames.check(run, modes, encode=frames.to_u8)
