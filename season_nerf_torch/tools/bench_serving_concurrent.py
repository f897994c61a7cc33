"""Concurrent-client latency and throughput of the HTTP render service.

The service renders one frame at a time behind a lock
(``render/serving.py``'s ``RenderService``: one card, one stream), so
concurrent clients queue.  This measures what the queueing does to the
service: per-request latency (median, p95, mean, max) and frames/s and
rays/s at 1, 4 and 16 concurrent clients, against a live
``ThreadingHTTPServer`` over a model directory (the stack
``serve_render`` deploys).

    python -m season_nerf_torch.tools.bench_serving_concurrent MODEL_DIR \\
        [--size 128] [--clients 1 4 16] [--requests 8] \\
        [--fast_render N_C N_F] [--device cpu]

Prints one JSON line per level and writes the table to ``--output``
(default ``MODEL_DIR/serving_concurrency.json``).  The counterpart of
``tools/bench_serving_concurrent.py``, with its flags and JSON (and each
level's ``max_s``).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import urllib.request

import numpy as np


def run_level(base_url: str, n_clients: int, n_requests: int, size: int):
    """``n_clients`` threads x ``n_requests`` sequential GETs each ->
    (latencies, wall seconds, errors)."""
    lat = []
    lock = threading.Lock()
    errors = []

    # a view and time of their own for every request: no layer can reuse
    # a frame
    def client(cid: int):
        for r in range(n_requests):
            va_el = 55 + (cid * 7 + r * 3) % 30
            va_az = (cid * 41 + r * 29) % 360
            tf = ((cid + 1) * (r + 1) * 0.07) % 1.0
            url = (f"{base_url}/render?view_el={va_el}&view_az={va_az}"
                   f"&sun_el=45&sun_az=180&t={tf:.3f}&size={size}")
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(url, timeout=600) as resp:
                    resp.read()
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)
            except Exception as e:   # noqa: BLE001 - report, go on
                with lock:
                    errors.append(str(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return lat, wall, errors


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model_dir")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--clients", type=int, nargs="*", default=[1, 4, 16])
    p.add_argument("--requests", type=int, default=8,
                   help="requests per client")
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--fast_render", type=int, nargs=2, default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    args = p.parse_args(argv)

    from season_nerf_torch.render.serving import RenderService, make_server

    service = RenderService(
        args.model_dir, n_samples=args.n_samples,
        fast_render=tuple(args.fast_render) if args.fast_render else None,
        device=args.device)
    server = make_server(service, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    try:
        # warm-up: the kernels' first build and launch outside the timings
        with urllib.request.urlopen(
                f"{base}/render?view_el=70&view_az=40&sun_el=45&sun_az=180"
                f"&t=0.5&size={args.size}", timeout=600) as resp:
            resp.read()

        rays_per_frame = args.size * args.size
        table = []
        for n in args.clients:
            lat, wall, errors = run_level(base, n, args.requests, args.size)
            if errors:
                print(f"[serve-bench] {len(errors)} errors at {n} clients: "
                      f"{errors[:2]}")
            lat = np.asarray(sorted(lat))
            row = {
                "clients": n,
                "requests": int(lat.size),
                "size": args.size,
                "p50_s": round(float(np.percentile(lat, 50)), 3),
                "p95_s": round(float(np.percentile(lat, 95)), 3),
                "mean_s": round(float(lat.mean()), 3),
                "max_s": round(float(lat.max()), 3),
                "frames_per_s": round(lat.size / wall, 3),
                "rays_per_s": round(lat.size * rays_per_frame / wall, 1),
                "errors": len(errors),
            }
            table.append(row)
            print(json.dumps(row))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    out = args.output or os.path.join(args.model_dir,
                                      "serving_concurrency.json")
    report = {"model_dir": os.path.abspath(args.model_dir),
              "fast_render": args.fast_render, "levels": table}
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[serve-bench] wrote {out}")
    return report


if __name__ == "__main__":
    main()
