"""HTTP render serving: a trained model directory as a long-lived service.

The service of ``season_nerf_tpu/render/serving.py`` on the port: load the
model once onto the card, answer novel-view requests over plain HTTP.

- ``GET /healthz``  liveness + model identity (JSON); 503 ``status=wedged``
  once one render has held the device longer than ``--wedge_timeout``
- ``GET /info``     site/config summary (JSON)
- ``GET /render?view_el=70&view_az=30&sun_el=45&sun_az=180&t=07/19``
  PNG novel view.  Optional: ``size`` (square, default 256), ``layer`` =
  ``season`` (default, shadow-adjusted seasonal composite) | ``base`` |
  ``shadow``, ``exact_shadow=1`` for secondary-ray shadows.
- ``GET /dsm?size=256``  nadir height map; ``format=npy`` (default, NaN =
  no data) or ``format=png`` (min-max stretched preview; 0 = no data).
  Meters when the model directory records the site height range, else the
  [-1, 1] cube; the ``X-DSM-Units`` header says which.

One render at a time holds the device (a lock); the threaded server keeps
health checks from queueing behind a frame.  Spans (``utils/trace``):
``serve.request`` from a request's handler to its response written (it
starts the request: every span beneath it on the handler's thread carries
its id), ``serve.lock_wait`` waiting for the lock, ``serve.render``
holding it, ``serve.encode`` the PNG.  Stdlib only: ``http.server``
and the port's own PNG encoder.

    python -m season_nerf_torch.render.serving --Model_Location DIR \
        [--fast_render N_COARSE N_FINE]

``--fast_render`` serves every frame depth-guided (``render/renderer``).
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from season_nerf_torch.geometry.time_enc import year_frac_from_month_day
from season_nerf_torch.render.loading import load_model_dir
from season_nerf_torch.render.renderer import images_from_components
from season_nerf_torch.utils import trace
from season_nerf_torch.utils.png import encode_png


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def parse_time(tf: str) -> float:
    """``MM/DD`` or a year fraction string -> year fraction in [0, 1)."""
    if "/" in tf:
        month, day = tf.split("/")
        return year_frac_from_month_day(int(month), int(day))
    frac = float(tf)
    if not 0.0 <= frac < 1.0 + 1e-9:
        raise ValueError(f"year fraction out of [0, 1): {frac}")
    return frac


def _parse_bool(val: str, name: str) -> bool:
    low = str(val).strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(f"boolean query parameter {name} got {val!r}")


class RenderService:
    """Thread-safe render facade over a loaded model directory."""

    LAYERS = ("season", "base", "shadow")

    def __init__(self, model_dir: str, n_samples: Optional[int] = None,
                 wedge_timeout: Optional[float] = 600.0,
                 fast_render: Optional[Tuple[int, int]] = None,
                 device="cuda"):
        self.model_dir = os.path.abspath(model_dir)
        # a long-lived service on a host of several cards renders every
        # chunk over the render mesh, as a one-shot render does
        loaded = load_model_dir(model_dir, n_samples=n_samples,
                                use_mesh=True, fast_render=fast_render,
                                device=device)
        self.cfg, self.renderer = loaded.cfg, loaded.renderer
        self.angles_to_vec, self.h_range = (loaded.angles_to_vec,
                                            loaded.h_range)
        self._lock = threading.Lock()
        self.renders_served = 0
        self.wedge_timeout = wedge_timeout
        self._busy_since: Optional[float] = None

    def busy_seconds(self) -> Optional[float]:
        """Seconds the current render has held the device (None if idle)."""
        t0 = self._busy_since
        return None if t0 is None else time.monotonic() - t0

    def wedged(self) -> bool:
        busy = self.busy_seconds()
        return (self.wedge_timeout is not None and busy is not None
                and busy > self.wedge_timeout)

    def info(self) -> dict:
        return {"model_dir": self.model_dir,
                "site_name": self.cfg.site_name,
                "exp_name": self.cfg.exp_name,
                "n_samples": self.renderer.n_samples,
                "fast_render": list(self.renderer.fast_render)
                               if self.renderer.fast_render else None,
                "fc_units": self.cfg.fc_units,
                "classic_solar": bool(self.cfg.Solar_Type_2),
                "use_HSLuv": bool(self.cfg.use_HSLuv),
                "device": str(self.renderer.device),
                "renders_served": self.renders_served,
                "busy_seconds": self.busy_seconds(),
                "dsm_units": "meters" if self.h_range is not None
                             else "normalized",
                "h_range": list(self.h_range)
                           if self.h_range is not None else None}

    def render_view(self, view_el_az: Tuple[float, float],
                    sun_el_az: Tuple[float, float], time_frac: float,
                    size: int = 256, layer: str = "season",
                    exact_shadow: bool = False) -> np.ndarray:
        """-> float image in [0, 1] (NaN where no ray was rendered)."""
        if layer not in self.LAYERS:
            raise ValueError(f"layer must be one of {self.LAYERS}")
        # The common layers come from the whole-image path (per-ray
        # composites only); the rest from the per-sample component path.
        exact = exact_shadow and layer != "base"
        fused = (not exact) and layer in ("season", "shadow") \
            and not self.cfg.Solar_Type_2 and not self.cfg.use_HSLuv
        with trace.span("serve.lock_wait"):
            self._lock.acquire()
        try:
            with trace.span("serve.render"):
                self._busy_since = time.monotonic()
                if fused:
                    out = self.renderer.render_img(
                        tuple(view_el_az), tuple(sun_el_az),
                        float(time_frac), size,
                        angles_to_vec=self.angles_to_vec)
                else:
                    comp = self.renderer.component_render_by_dir(
                        tuple(view_el_az), tuple(sun_el_az),
                        float(time_frac), (size, size),
                        angles_to_vec=self.angles_to_vec,
                        exact_solar=exact)
                self.renders_served += 1
        finally:
            self._busy_since = None
            self._lock.release()
        if fused:
            if layer == "shadow":
                gate = _sig((out["Shadow_Mask"] - 0.2) * 30.0)
                return np.where(out["Mask"], gate, np.nan)
            return np.where(out["Mask"][..., None], out["Col_Img"], np.nan)
        imgs = images_from_components(comp, (size, size),
                                      classic_shadows=self.cfg.Solar_Type_2)
        if layer == "base":
            return imgs["Base_Img"]
        if layer == "shadow":
            return imgs["Shadow_Mask_Exact" if exact else "Shadow_Mask"]
        adj = imgs["Shadow_Adjust_Exact" if exact else "Shadow_Adjust"]
        return imgs["Season_Adj_Img"] * adj

    def dsm(self, size: int = 256) -> Tuple[np.ndarray, str]:
        """Nadir height map -> (array, units): ``"meters"`` when the model
        directory records the site height range, else ``"normalized"``."""
        with self._lock:
            self._busy_since = time.monotonic()
            try:
                out = self.renderer.get_dsm(size)
                self.renders_served += 1
            finally:
                self._busy_since = None
        if self.h_range is not None:
            h0, h1 = self.h_range
            return (out + 1.0) / 2.0 * (h1 - h0) + h0, "meters"
        return out, "normalized"


def to_u8(img: np.ndarray, stretch: bool = False) -> np.ndarray:
    """Float image -> uint8.  ``stretch`` (height maps): min-max normalize
    the finite pixels into 1..255 and keep 0 for NaN/no data.  Otherwise
    an absolute [0, 1] clip (a uniformly lit shadow mask stays white)."""
    arr = np.asarray(img, np.float32)
    if stretch and arr.ndim == 2:
        finite = np.isfinite(arr)
        if not finite.any():
            return np.zeros(arr.shape, np.uint8)
        lo, hi = arr[finite].min(), arr[finite].max()
        span = (arr - lo) / (hi - lo) if hi > lo else np.ones_like(arr)
        span = np.where(finite, span, 0.0)
        return np.where(finite, 1 + np.clip(span, 0.0, 1.0) * 254,
                        0).astype(np.uint8)
    arr = np.nan_to_num(arr, nan=0.0)
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def png_bytes(img: np.ndarray, stretch: bool = False) -> bytes:
    return encode_png(to_u8(img, stretch))


def npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    service: RenderService = None      # set by make_server

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("SERVE_RENDER_VERBOSE"):
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str, headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj: dict):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        with trace.span("serve.request", request=True):
            self._get()

    def _get(self):
        url = urlparse(self.path)
        q = {k: v[-1] for k, v in parse_qs(url.query).items()}
        try:
            if url.path == "/healthz":
                if self.service.wedged():
                    return self._json(503, {"status": "wedged",
                                            **self.service.info()})
                return self._json(200, {"status": "ok",
                                        **self.service.info()})
            if url.path == "/info":
                return self._json(200, self.service.info())
            if url.path == "/render":
                img = self.service.render_view(
                    (float(q.get("view_el", 70.0)),
                     float(q.get("view_az", 0.0))),
                    (float(q.get("sun_el", 45.0)),
                     float(q.get("sun_az", 180.0))),
                    parse_time(q.get("t", "0.5")),
                    size=int(q.get("size", 256)),
                    layer=q.get("layer", "season"),
                    exact_shadow=_parse_bool(q.get("exact_shadow", "0"),
                                             "exact_shadow"))
                with trace.span("serve.encode"):
                    body = png_bytes(img)
                return self._send(200, body, "image/png")
            if url.path == "/dsm":
                arr, units = self.service.dsm(int(q.get("size", 256)))
                hdr = (("X-DSM-Units", units),)
                if q.get("format", "npy") == "png":
                    return self._send(200, png_bytes(arr, stretch=True),
                                      "image/png", hdr)
                return self._send(200, npy_bytes(arr),
                                  "application/octet-stream", hdr)
            return self._json(404, {"error": f"unknown path {url.path}"})
        except (ValueError, KeyError) as e:
            return self._json(400, {"error": str(e)})
        except BrokenPipeError:
            pass
        except Exception as e:        # surface server faults to the client
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(service: RenderService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral); the caller runs serve_forever."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--Model_Location", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("--warmup", action="store_true",
                   help="render one small frame before accepting traffic")
    p.add_argument("--wedge_timeout", type=float, default=600.0,
                   help="healthz reports 503/wedged once a single render "
                        "has held the device this many seconds "
                        "(0 disables)")
    p.add_argument("--fast_render", type=int, nargs=2, default=None,
                   metavar=("N_COARSE", "N_FINE"),
                   help="depth-guided fast rendering for every served "
                        "frame")
    args = p.parse_args(argv)
    service = RenderService(args.Model_Location, n_samples=args.n_samples,
                            wedge_timeout=args.wedge_timeout or None,
                            fast_render=args.fast_render, device=args.device)
    if args.warmup:
        service.render_view((70, 0), (45, 180), 0.5, size=32)
    server = make_server(service, args.host, args.port)
    print(f"serving {service.info()['site_name']} on "
          f"http://{args.host}:{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
