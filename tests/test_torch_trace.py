"""The port's tracer (``season_nerf_torch/utils/trace.py``) and its spans at
the layer boundaries: the HTTP service, the renderer, the training step
and the SIREN layer on the CPU; K1, K2 and K3's launch spans and counters
on the card (marker ``gpu``: ``python -m pytest -m gpu --noconftest
tests/test_torch_trace.py``).  No JAX: the tracer has no counterpart
there.  About 10 s on one worker."""

from __future__ import annotations

import threading
import urllib.request

import numpy as np
import pytest
import torch

from season_nerf_torch.config import Config
from season_nerf_torch.models.siren import SineLayer
from season_nerf_torch.models.tnerf import model_from_config
from season_nerf_torch.ops import batchnorm_train as bt
from season_nerf_torch.ops import fast_math
from season_nerf_torch.ops import fused_train as ftr
from season_nerf_torch.ops import fused_trunk as ft
from season_nerf_torch.train.state import save_model_artifact
from season_nerf_torch.utils import trace

torch.set_num_threads(1)

RENDER_SPANS = {"serve.lock_wait", "serve.render", "serve.encode",
                "render.frame", "render.rays", "render.chunk",
                "render.gather", "render.scatter", "siren.sine"}


@pytest.fixture
def on():
    """Spans on for one test; off and drained afterwards whatever
    happens."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_returns_one_shared_context_and_records_nothing():
    trace.disable()
    trace.drain()
    assert trace.span("a") is trace.span("b", request=True)
    with trace.span("a"):
        with trace.span("b"):
            pass
    assert trace.drain() == []


def test_on_records_times_parents_and_the_thread(on):
    with trace.span("outer") as o:
        with trace.span("inner") as i:
            pass
        with trace.span("next"):
            pass
    spans = trace.drain()
    assert [s.name for s in spans] == ["inner", "next", "outer"]
    inner, nxt, outer = spans
    assert (outer.id, inner.id) == (o.id, i.id)
    assert outer.parent is None and inner.parent == nxt.parent == outer.id
    assert len({outer.id, inner.id, nxt.id}) == 3
    assert outer.start <= inner.start <= inner.end <= nxt.start \
        <= nxt.end <= outer.end
    assert {s.thread for s in spans} == {threading.get_native_id()}
    assert all(s.request is None for s in spans)


def test_a_request_id_is_inherited_beneath_it_on_its_own_thread(on):
    seen = {}

    def other():
        with trace.span("worker"):
            seen["thread"] = threading.get_native_id()

    with trace.span("serve.request", request=True) as req:
        with trace.span("a"):
            with trace.span("b"):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
    assert not t.is_alive()
    with trace.span("after"):
        pass
    s = _by_name(trace.drain())
    assert s["serve.request"][0].request == req.id
    assert s["a"][0].request == s["b"][0].request == req.id
    assert s["b"][0].parent == s["a"][0].id
    worker = s["worker"][0]
    assert worker.request is None and worker.parent is None
    assert worker.thread == seen["thread"] != s["a"][0].thread
    assert s["after"][0].request is None


def test_drain_returns_the_ended_spans_once_and_disable_stops(on):
    for name in ("x", "y"):
        with trace.span(name):
            pass
    assert [s.name for s in trace.drain()] == ["x", "y"]
    assert trace.drain() == []
    trace.disable()
    with trace.span("z"):
        pass
    assert trace.drain() == []


def test_a_span_ends_when_its_body_raises(on):
    with pytest.raises(ValueError):
        with trace.span("outer"):
            with trace.span("raises"):
                raise ValueError("x")
    with trace.span("later"):
        pass
    s = _by_name(trace.drain())
    assert s["raises"][0].parent == s["outer"][0].id
    assert s["later"][0].parent is None      # the thread's stack unwound


def test_the_profiler_carries_the_span_names(on):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("render.chunk"):
            torch.ones(4).sum()
    assert "render.chunk" in {e.name for e in prof.events()}
    assert [s.name for s in trace.drain()] == ["render.chunk"]


def test_counters_read_the_launch_counters(monkeypatch):
    assert trace.counters() == {"k3.launches": ft.trunk_apply.launches,
                                "k1.launches": ftr.trunk_fwd.launches,
                                "k2.launches": ftr.trunk_bwd.launches,
                                "fast_sine.launches": fast_math.launches,
                                "batchnorm.launches": bt.launches}
    monkeypatch.setattr(ftr.trunk_fwd, "launches",
                        ftr.trunk_fwd.launches + 2)
    monkeypatch.setattr(ftr.trunk_bwd, "launches",
                        ftr.trunk_bwd.launches + 1)
    monkeypatch.setattr(fast_math, "launches", fast_math.launches + 3)
    monkeypatch.setattr(bt, "launches", bt.launches + 4)
    assert trace.counters()["k1.launches"] == ftr.trunk_fwd.launches
    assert trace.counters()["k2.launches"] == ftr.trunk_bwd.launches
    assert trace.counters()["fast_sine.launches"] == fast_math.launches
    assert trace.counters()["batchnorm.launches"] == bt.launches
    assert not hasattr(ftr.gemm_bf16, "launches")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("traced")
    cfg = Config(site_name="traced", fc_units=32, fc_layers=2, n_samples=8,
                 chunk=40)
    cfg.save_json(str(d / "opts.json"))
    torch.manual_seed(0)
    save_model_artifact(str(d / "Final_Model.nn"),
                        model_from_config(cfg).state_dict())
    return str(d)


def test_served_requests_carry_their_ids_through_the_render(model_dir, on):
    """Two requests at once from two clients: each handler thread's
    spans, down to the renderer's chunks and the SIREN sines, carry the
    id of that thread's ``serve.request``."""
    from season_nerf_torch.render.serving import RenderService, make_server
    svc = RenderService(model_dir, device="cpu")
    server = make_server(svc, "127.0.0.1", 0)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/render?size=8"
    bodies = []

    def get(az):
        with urllib.request.urlopen(f"{url}&view_az={az}", timeout=60) as r:
            bodies.append(r.read())

    try:
        trace.drain()
        clients = [threading.Thread(target=get, args=(az,))
                   for az in (10, 200)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert not any(c.is_alive() for c in clients)
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    assert len(bodies) == 2 and all(b[:4] == b"\x89PNG" for b in bodies)
    spans = trace.drain()
    requests = [s for s in spans if s.name == "serve.request"]
    assert len(requests) == 2
    assert {r.request for r in requests} == {r.id for r in requests}
    main = threading.get_native_id()
    for r in requests:
        mine = _by_name(s for s in spans if s.request == r.id
                        and s.name != "serve.request")
        assert RENDER_SPANS <= set(mine)
        assert {s.thread for v in mine.values() for s in v} == {r.thread}
        assert r.thread != main
        frame, = mine["render.frame"]
        render, = mine["serve.render"]
        assert mine["serve.lock_wait"][0].parent == r.id
        assert render.parent == r.id and frame.parent == render.id
        assert len(mine["render.chunk"]) == 2          # 64 rays, chunk 40
        assert all(c.parent == frame.id for c in mine["render.chunk"])
        for s in (v for vs in mine.values() for v in vs):
            assert r.start <= s.start <= s.end <= r.end


def test_the_renderer_spans_without_a_service(model_dir, on):
    from season_nerf_torch.render.loading import load_model_dir
    r = load_model_dir(model_dir, device="cpu").renderer
    out = r.render_img((70.0, 30.0), (45.0, 160.0), 0.4, 8)
    assert out["Col_Img"].shape == (8, 8, 3)
    s = _by_name(trace.drain())
    frame, = s["render.frame"]
    assert frame.parent is None and frame.request is None
    for name in ("render.rays", "render.chunk", "render.gather",
                 "render.scatter"):
        assert all(x.parent == frame.id for x in s[name]), name
    assert len(s["render.chunk"]) == 2
    assert "k3.launch" not in s                  # the CPU runs no kernel
    assert all(x.parent is not None for x in s["siren.sine"])


def _trainer(device="cpu", **kw):
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.train.engine import Trainer
    scene = make_scene(n_views=3, img_size=16, grid=16, seed=0)
    table, _ = scene_ray_tables(scene, testing_size=1)
    cfg = Config(**{**dict(fc_units=32, batch_size=16, n_samples=8,
                           max_train_steps=10, compute_dtype="float32",
                           fast_sine=True), **kw})
    return Trainer(cfg, table, prior_hm=scene.prior_hm, device=device)


def test_a_train_step_emits_its_phases_and_the_siren_spans(on):
    tr = _trainer()
    trace.drain()
    tr.train_step()
    spans = trace.drain()
    s = _by_name(spans)
    step, = s["train.step"]
    phases = ("train.draws", "train.gather", "train.forward",
              "train.backward", "train.optimizer")
    got = [x.name for x in sorted(spans, key=lambda x: x.start)
           if x.parent == step.id]
    assert got == list(phases)
    ids = {x.id: x for x in spans}

    def under(x):
        while x.parent is not None:
            x = ids[x.parent]
            if x.name in phases:
                return x.name
        return None

    # the forward's sines and BatchNorms, and FastSin's backward (the CPU
    # runs autograd on the calling thread, so under train.backward)
    assert {under(x) for x in s["siren.sine"]} == {"train.forward",
                                                  "train.backward"}
    assert {under(x) for x in s["siren.batchnorm"]} == {"train.forward"}
    assert "k1.launch" not in s and "k2.launch" not in s


def test_the_batchnorm_functions_spans_lie_in_their_phases(on):
    """The training BatchNorm's Function (its plain version here; the
    kernels open the same spans): ``siren.batchnorm`` and ``siren.sine``
    under the forward, and backward ``siren.sine`` then the dz pass's
    ``siren.batchnorm_bwd``, under ``train.backward`` and in neither
    ``siren.sine`` nor ``siren.batchnorm``, so that the readers of those
    two keep their meaning."""
    norm = torch.nn.BatchNorm1d(16)
    z = torch.randn(40, 16).bfloat16().requires_grad_()
    with trace.span("train.forward"):
        y = bt.batchnorm_sine(z, norm, plain=True)
    with trace.span("train.backward"):
        y.float().sum().backward()
    spans = trace.drain()
    s = _by_name(spans)
    ids = {x.id: x for x in spans}

    def ancestors(x):
        out = []
        while x.parent is not None:
            x = ids[x.parent]
            out.append(x.name)
        return out

    assert [ancestors(x) for x in s["siren.batchnorm"]] == [["train.forward"]]
    assert sorted(ancestors(x)[-1] for x in s["siren.sine"]) \
        == ["train.backward", "train.forward"]
    dz, = s["siren.batchnorm_bwd"]
    assert ancestors(dz) == ["train.backward"]
    sine_back, = [x for x in s["siren.sine"] if x.parent == dz.parent]
    assert sine_back.end <= dz.start


@pytest.mark.parametrize("strict", [False, True])
def test_export_of_a_sine_layer_passes_with_the_tracer(strict):
    """``torch.export`` reaches ``SineLayer.forward`` (the exported render
    programs): off, the spans are the shared no-op context; on, they are
    skipped while the program is traced."""
    layer = SineLayer(8, 16, use_norm=True, fast_sine=True).eval()
    x = torch.randn(5, 8)
    trace.drain()
    for enabled in (False, True):
        (trace.enable if enabled else trace.disable)()
        try:
            ep = torch.export.export(layer, (x,), strict=strict)
        finally:
            trace.disable()
        assert trace.drain() == []
        torch.testing.assert_close(ep.module()(x), layer(x))


def test_compiled_code_skips_the_spans(on):
    layer = SineLayer(8, 16, use_norm=True, fast_sine=True).eval()
    x = torch.randn(5, 8)
    want = layer(x)
    assert {s.name for s in trace.drain()} == {"siren.sine",
                                               "siren.batchnorm"}
    torch._dynamo.reset()
    got = torch.compile(layer, backend="eager", fullgraph=True)(x)
    torch.testing.assert_close(got, want)
    assert trace.drain() == []


# --- on the card -----------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    """The card; the cases below skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on a machine with "
                    "one (see the module docstring)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_step_spans_k1_twice_and_k2_once(cuda, on):
    """With ``pallas_trunk`` a step launches K1 twice (camera and solar
    pass) and K2 once: one ``k1.launch`` / ``k2.launch`` span each, and
    the counters move by as many.  K2 runs in the backward, on autograd's
    thread for the card."""
    tr = _trainer(device=cuda, fc_units=256, batch_size=64, n_samples=32,
                  compute_dtype="bfloat16", pallas_trunk=True)
    tr.train_step()
    before = trace.counters()
    trace.drain()
    for _ in range(2):
        tr.train_step()
    torch.cuda.synchronize(cuda)
    after = trace.counters()
    s = _by_name(trace.drain())
    assert (after["k1.launches"] - before["k1.launches"],
            after["k2.launches"] - before["k2.launches"]) == (4, 2)
    assert (len(s["k1.launch"]), len(s["k2.launch"])) == (4, 2)
    steps = {x.thread for x in s["train.step"]}
    assert {x.thread for x in s["k1.launch"]} == steps


@pytest.mark.gpu
def test_card_render_spans_one_k3_launch_a_chunk(cuda, model_dir, on):
    from season_nerf_torch.render.loading import load_model_dir
    r = load_model_dir(model_dir, device=str(cuda)).renderer
    r.render_img((70.0, 30.0), (45.0, 160.0), 0.4, 8)
    before = trace.counters()["k3.launches"]
    trace.drain()
    out = r.render_img((70.0, 30.0), (45.0, 160.0), 0.4, 8)
    assert np.isfinite(out["Col_Img"]).all()
    s = _by_name(trace.drain())
    assert trace.counters()["k3.launches"] - before \
        == len(s["k3.launch"]) == len(s["render.chunk"]) == 2
    chunks = {x.id for x in s["render.chunk"]}
    ids = {x.id: x for v in s.values() for x in v}

    def chunk_of(x):
        while x.parent is not None and x.parent not in chunks:
            x = ids[x.parent]
        return x.parent

    assert all(chunk_of(x) in chunks for x in s["k3.launch"])
