"""The port's spans and counters as the harness reads them: kernels laid
under the program span that launched them on a synthetic chrome trace,
the clocks tied by the spans' annotations, the idle gaps' three-field
label, the readers of spans and counters, the sine kernel's bytes, and
the tracer left alone by an untraced run."""

import types

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import bench, trace
from portbench import run as harness
from portbench.counts import k1k2, sine
from portbench.tests.conftest import small
from season_nerf_torch.utils.trace import Span

OFF = 1000.0            # the profiler's clock less the host's, seconds
MS = 1e-3


def _span(name, start, end, id, parent=None, thread=7, request=None):
    return Span(name, start, end, id, parent, request, thread)


class Events:
    """A chrome trace of the profiler's events, written on the host's
    clock and shifted by ``OFF``."""

    def __init__(self, sync_error=0.0):
        self.items = [{"name": trace.SYNC, "cat": "user_annotation",
                       "ts": (0.5 + OFF + sync_error) * 1e6, "dur": 1.0,
                       "tid": 7}]
        self.corr = 0

    def note(self, s: Span, tid=None, enter=0.0, exit=0.0):
        """The annotation a program span opens: ``enter`` seconds before
        the span's start (the cost of opening its ``record_function``)
        and ``exit`` after its end."""
        self.items.append({"name": s.name, "cat": "user_annotation",
                           "ts": (s.start - enter + OFF) * 1e6,
                           "dur": (s.end - s.start + enter + exit) * 1e6,
                           "tid": s.thread if tid is None else tid})

    def host_op(self, name, start, end, tid=7):
        self.items.append({"name": name, "cat": "cpu_op",
                           "ts": (start + OFF) * 1e6,
                           "dur": (end - start) * 1e6, "tid": tid})

    def kernel(self, name, start, dur, launched_at=None, tid=7):
        """A kernel on the device over ``[start, start + dur)``, launched
        from ``tid`` at ``launched_at`` (none recorded when None)."""
        self.corr += 1
        self.items.append({"name": name, "cat": "kernel",
                           "ts": (start + OFF) * 1e6, "dur": dur * 1e6,
                           "tid": "stream 7",
                           "args": {"correlation": self.corr}})
        if launched_at is not None:
            self.items.append({"name": "cudaLaunchKernel",
                               "cat": "cuda_runtime",
                               "ts": (launched_at + OFF) * 1e6, "dur": 3.0,
                               "tid": tid,
                               "args": {"correlation": self.corr}})

    def read(self, program, start=0.0, end=20.0):
        return trace.read_events(self.items, 0.5, start, end, program)


# -- attribution ----------------------------------------------------------
def _training_spans():
    return [_span("train.step", 1.0, 11.0, 1),
            _span("train.backward", 2.0, 9.0, 2, parent=1),
            _span("siren.sine", 3.0, 4.0, 3, parent=2)]


def test_a_kernel_goes_to_the_innermost_span_on_its_thread():
    spans = _training_spans()
    ev = Events()
    for s in spans:
        ev.note(s)
    ev.kernel("fast_sine_bwd", 3.6, 2 * MS, launched_at=3.5)
    ev.kernel("mm", 5.1, 5 * MS, launched_at=5.0)
    ev.kernel("copy", 0.2, 7 * MS, launched_at=0.1)      # before any span
    tr = ev.read(spans)
    assert tr.device_s_under("siren.sine") == pytest.approx(2 * MS)
    assert tr.device_s_under("train.backward") == pytest.approx(7 * MS)
    assert tr.device_s_under("train.step") == pytest.approx(7 * MS)
    assert tr.device_s_under("train.forward") == 0.0
    assert tr.device_s() == pytest.approx(14 * MS)


def test_another_threads_launch_takes_the_deepest_open_span():
    """A handler thread's launch (an id that is no span's thread) goes to
    the deepest span open on any thread, never to a wait for the render
    lock, however deep."""
    spans = [_span("serve.request", 0.0, 10.0, 1, thread=8),
             _span("serve.render", 1.0, 9.0, 2, parent=1, thread=8),
             _span("render.frame", 2.0, 8.0, 3, parent=2, thread=8),
             _span("render.chunk", 3.0, 5.0, 4, parent=3, thread=8),
             _span("serve.request", 0.5, 12.0, 5, thread=9),
             _span("serve.encode", 0.6, 0.9, 6, parent=5, thread=9),
             _span("serve.lock_wait", 1.0, 11.0, 7, parent=5, thread=9)]
    ev = Events()
    ev.kernel("trunk_bf16", 4.1, 3 * MS, launched_at=4.0, tid=4242)
    ev.kernel("copy", 8.6, 1 * MS, launched_at=8.5, tid=4242)
    ev.kernel("late", 10.6, 2 * MS, launched_at=10.5, tid=4242)
    tr = ev.read(spans)
    assert tr.device_s_under("render.chunk") == pytest.approx(3 * MS)
    assert tr.device_s_under("serve.render") == pytest.approx(4 * MS)
    # at 10.5 the only open spans are thread 9's request and its wait
    assert tr.device_s_under("serve.lock_wait") == 0.0
    assert tr.device_s_under("serve.request") == pytest.approx(6 * MS)


def test_an_unlaunched_or_unspanned_kernel_lies_under_nothing():
    spans = _training_spans()
    ev = Events()
    ev.kernel("orphan", 3.6, 2 * MS)                  # no launch event
    tr = ev.read(spans)
    assert tr.device_s_under("train.step") == 0.0
    assert trace.read_events(ev.items, 0.5, 0.0, 20.0, None) \
        .device_s_under("train.step") == 0.0


# -- the clocks -----------------------------------------------------------
def test_the_annotations_tie_the_clocks():
    """The marker is 1.2 ms off; the spans' annotations put every device
    operation back where it ran on the host's clock, though spans of one
    name come every 0.5 ms (ambiguous within the marker's error)."""
    spans = [_span("train.step", 1.0, 3.0, 1)]
    spans += [_span("siren.sine", 1.1 + 0.0005 * i, 1.1003 + 0.0005 * i,
                    2 + i, parent=1) for i in range(100)]
    ev = Events(sync_error=1.2 * MS)
    for s in spans:
        ev.note(s)
    ev.kernel("k", 2.0, 1 * MS)
    tr = ev.read(spans)
    assert tr.ops[0][1] == pytest.approx(2.0, abs=1e-9)
    # without program spans the marker ties them, 1.2 ms off
    off = trace.read_events(ev.items, 0.5, 0.0, 20.0)
    assert off.ops[0][1] == pytest.approx(2.0 - 1.2 * MS, abs=1e-9)


def test_the_tie_keeps_its_guess_without_a_lone_annotation():
    spans = [_span("a", 1.0, 2.0, 1), _span("a", 1.001, 2.0, 2)]
    notes = [("a", 1.0 + OFF, 2.0 + OFF, 7), ("a", 1.001 + OFF, 2.0 + OFF, 7)]
    assert trace.tie(notes, spans, OFF + 0.3 * MS) == OFF + 0.3 * MS
    assert trace.tie(notes[:1], spans[:1], OFF + 0.3 * MS) == \
        pytest.approx(OFF)
    assert trace.tie([], [], 5.0) == 5.0


def test_a_launch_as_its_block_closes_lies_under_its_span():
    """Each span's annotation opens 30 us before its start and closes 2 us
    after its end, so the tie of midpoints puts the launches 14 us late on
    the host's clock; the last launch of a block, 5 us before the span's
    end, still lies under it, as the span takes its annotation's edges.
    Where a thread's spans of a name and their annotations differ in
    number, the spans keep their own edges."""
    step = _span("train.step", 1.0, 3.0, 1)
    norms = [_span("siren.batchnorm", 1.1 + 0.1 * i, 1.15 + 0.1 * i, 2 + i,
                   parent=1) for i in range(8)]
    ev = Events()
    for sp in [step] + norms:
        ev.note(sp, enter=30e-6, exit=2e-6)
    for sp in norms:
        ev.kernel("reduce", sp.start + 0.01, 1 * MS, launched_at=sp.start + 1e-5)
        ev.kernel("add", sp.end + 0.01, 1 * MS, launched_at=sp.end - 5e-6)
    tr = ev.read([step] + norms)
    assert tr.device_s_under("siren.batchnorm") == pytest.approx(16 * MS)
    moved = trace.on_trace_clock(
        norms, [("siren.batchnorm", sp.start + OFF, sp.end + OFF, 7)
                for sp in norms[1:]], OFF)
    assert moved == norms


# -- idle gaps -----------------------------------------------------------
def test_the_idle_gaps_label_has_three_fields():
    """<benchmark span> / <program span> / <host op>: the deepest program
    span that covers at least half of the gap, the program's own
    annotations never the host op."""
    program = [_span("train.step", 0.0, 10.0, 1),
               _span("train.backward", 1.5, 3.5, 2, parent=1),
               _span("siren.sine", 2.0, 2.9, 3, parent=2),
               _span("train.optimizer", 6.2, 6.9, 4, parent=1)]
    ev = Events()
    for s in program:
        ev.note(s)
    ev.host_op("aten::index", 2.0, 3.0)
    ev.host_op("aten::to", 6.0, 7.9)
    for t in (0.0, 3.0, 8.0):
        ev.kernel("k", t, 1.0)
    tr = ev.read(program, 0.0, 9.0)
    bench_spans = trace.Spans()
    bench_spans.items.append(("train_step", 0.0, 10.0))
    gaps = {round(g, 6): label for label, g in
            tr.breakdown(bench_spans)["idle_gaps"]}
    # [1, 3): train.backward covers 1.5 s of 2; siren.sine 0.9, under half
    assert gaps[2.0] == "train_step / train.backward / aten::index"
    # [4, 8): train.optimizer covers 0.7 s of 4, so only the step is named
    assert gaps[4.0] == "train_step / train.step / aten::to"
    bare = ev.read(None, 0.0, 9.0).breakdown(trace.Spans())["idle_gaps"]
    # without program spans their annotations are host operations
    assert {label for label, _ in bare} == {
        "no span / no program span / train.step"}


# -- the readers ----------------------------------------------------------
GHOST = bench.cell("train-bf16-ghostbn").config
DEFAULT = bench.cell("train-bf16-default").config
SERVE = bench.cell("serve-bf16-mixed").config


def _run(config, program, ev=None, counts=None, work=None,
         window=(0.0, 100.0)):
    ev = ev or Events()
    return types.SimpleNamespace(
        config=config, trace=ev.read(program, *window),
        program_spans=program, counts=counts, work=work or {},
        window_span=window)


def _read(name, run):
    return bench.reader(name).read(run)


def test_k1_k2_rooflines():
    """Bound a launch x the window's launches over the device time under
    each launch span: 10 % and 12.5 %."""
    b1, b2 = k1k2.launch_bounds_s(GHOST)
    assert 2 * b1 + b2 == pytest.approx(k1k2.step_bound_s(GHOST))
    program, ev = [], Events()
    for i in range(2):                              # two steps
        t = 10.0 * i
        program += [_span("k1.launch", t, t + 0.1, 3 * i + 1),
                    _span("k1.launch", t + 1, t + 1.1, 3 * i + 2),
                    _span("k2.launch", t + 2, t + 2.1, 3 * i + 3)]
        ev.kernel("tt::gemm", t + 0.2, 10 * b1, launched_at=t + 0.05)
        ev.kernel("tt::gemm", t + 1.2, 10 * b1, launched_at=t + 1.05)
        ev.kernel("tt::bwd", t + 2.2, 8 * b2, launched_at=t + 2.05)
    run = _run(GHOST, program, ev, {"k1.launches": 4, "k2.launches": 2},
               {"steps": 2})
    assert _read("k1_roofline.train", run) == pytest.approx(10.0)
    assert _read("k2_roofline.train", run) == pytest.approx(12.5)


def test_sine_and_batchnorm_ms_a_step():
    program = [_span("train.step", 0.0, 50.0, 1),
               _span("siren.batchnorm", 1.0, 2.0, 2, parent=1),
               _span("siren.sine", 2.0, 3.0, 3, parent=1),
               _span("siren.sine", 30.0, 31.0, 4, thread=99)]
    ev = Events()
    ev.kernel("bn", 1.5, 48 * MS, launched_at=1.1)
    ev.kernel("fast_sine_fwd", 2.5, 9 * MS, launched_at=2.1)
    ev.kernel("fast_sine_bwd", 30.5, 8.6 * MS, launched_at=30.1, tid=99)
    run = _run(DEFAULT, program, ev, work={"steps": 1})
    assert _read("sine_ms.train", run) == pytest.approx(17.6)
    assert _read("batchnorm_ms.train", run) == pytest.approx(48.0)


def _sine_kernels(ev, launches, share, config):
    """One kernel a launch, each taking its bound over ``share``."""
    for i, (n, d) in enumerate(launches):
        ev.kernel(f"void (anonymous namespace)::fast_sine_{d}<false>",
                  1.0 + i * 1e-3, sine.launch_bound_s(config, n, d) / share)


def test_sine_roofline_train():
    steps = 3
    launches = sine.step_launches(DEFAULT) * steps
    ev = Events()
    _sine_kernels(ev, launches, 0.8, DEFAULT)
    ev.kernel("other", 50.0, 1.0)
    run = _run(DEFAULT, [], ev, {"fast_sine.launches": 49 * steps},
               {"steps": steps})
    assert _read("sine_roofline.train", run) == pytest.approx(80.0)
    run.counts = {"fast_sine.launches": 49 * steps - 1}
    assert _read("sine_roofline.train", run) is None


def test_sine_roofline_serve():
    frames = [64 * 64, 128 * 128, 64 * 64]
    launches = [x for r in frames for x in sine.frame_launches(SERVE, r)]
    assert len(launches) == 9 * (1 + 4 + 1)
    ev = Events()
    _sine_kernels(ev, launches, 0.9, SERVE)
    run = _run(SERVE, [], ev, {"fast_sine.launches": len(launches)},
               {"frames": frames})
    assert _read("sine_roofline.serve", run) == pytest.approx(90.0)
    run.counts = {"fast_sine.launches": len(launches) + 9}
    assert _read("sine_roofline.serve", run) is None


NEW = ["k1_roofline.train", "k2_roofline.train", "sine_ms.train",
       "batchnorm_ms.train", "sine_roofline.train", "sine_roofline.serve"]


@pytest.mark.parametrize("name", NEW)
def test_a_reader_is_silent_without_spans_and_counters(name):
    """A traced run on a port without spans or counters (as the parent
    tree handed the readers none) reads nothing."""
    ev = Events()
    ev.kernel("void fast_sine_fwd<false>", 1.0, 1 * MS, launched_at=0.9)
    ev.kernel("tt::gemm", 2.0, 1 * MS, launched_at=1.9)
    config = GHOST if name.startswith("k") else \
        DEFAULT if name.endswith(".train") else SERVE
    run = _run(config, None, ev, None,
               {"steps": 2, "frames": [4096], "rays": 4096})
    assert _read(name, run) is None


def test_the_new_readers_are_in_the_benchmark():
    per_layer = {m["name"]: m for m in bench.definitions()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["workloads"] and m["source"] in ("device_trace",
                                                   "host_clock")


# -- the sine kernel's bytes ----------------------------------------------
def test_sine_bounds_are_the_kernel_table():
    """At 393,216 x 512: forward 0.3606 ms with a bf16 store (0.4808 f32),
    backward 0.6010 ms with a bf16 gradient (0.7212 f32)."""
    n = 393216 * 512
    f32 = dict(DEFAULT, compute_dtype="float32")
    got = [round(sine.launch_bound_s(c, n, d) * 1e3, 4)
           for c in (DEFAULT, f32) for d in (sine.FWD, sine.BWD)]
    assert got == [0.3606, 0.601, 0.4808, 0.7212]
    assert len(sine.step_launches(DEFAULT)) == 49
    assert len(sine.step_launches(GHOST)) == 22
    assert len(sine.chunk_launches(SERVE, 5120)) == 9
    assert sine.step_launches(dict(DEFAULT, fast_sine=False)) == []


class _SineCalls(TorchDispatchMode):
    """Every call of the port's sine operators: one launch each on a
    card."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith("season_nerf::fast_sine"):
            self.calls.append((args[0].numel(), sine.BWD if "grad" in name
                               else sine.FWD))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cell", ["train-bf16-default",
                                  "train-bf16-ghostbn"])
def test_step_launches_are_the_ports(cell):
    """The launches reckoned for a step against the port's own calls of
    its sine operators over the checked steps of a run's set-up, on the
    CPU at a small size."""
    ov = small(cell)
    c = bench.cell(cell)
    for key, part in ov.items():
        getattr(c, key).update(part)
    r = harness.Run(c, 5, 1.0, torch.device("cpu"))
    try:
        with _SineCalls() as mode:
            bench.kind(c.traffic).setup(r)
    finally:
        r.close()
    want = sine.step_launches(c.config) * 3
    assert sorted(mode.calls) == sorted(want)


def test_frame_launches_are_the_ports():
    """A frame of 576 rays in chunks of 256 through the port's renderer:
    three chunks of the branches' launches."""
    from portbench import frames
    from season_nerf_torch.render.loading import load_model_dir
    cell = "serve-bf16-mixed"
    c = bench.cell(cell)
    c.config.update(small(cell)["config"])
    r = harness.Run(c, 6, 1.0, torch.device("cpu"))
    try:
        renderer = load_model_dir(frames.model_dir(r), device="cpu").renderer
        with _SineCalls() as mode:
            renderer.render_img((70.0, 10.0), (45.0, 180.0), 0.3, 24)
    finally:
        r.close()
    assert sorted(mode.calls) == sorted(sine.frame_launches(c.config, 576))


# -- the harness around the window ----------------------------------------
def test_an_untraced_run_leaves_the_ports_tracer_alone(monkeypatch):
    from season_nerf_torch.utils import trace as tracer

    def refuse(*a):
        raise AssertionError("an untraced run touched the tracer")
    for fn in ("enable", "drain", "counters"):
        monkeypatch.setattr(tracer, fn, refuse)
    cell = "render-f32-frames"
    res = harness.execute(cell, 81, 0.5, False, device="cpu",
                          overrides=small(cell), age=lambda: 0.0)
    monkeypatch.undo()
    assert res["correct"] and "breakdown" not in res
    assert not tracer._on and tracer.drain() == []


def test_only_the_cells_whose_readers_read_spans_turn_them_on():
    """The program's spans cost the host some microseconds each: a traced
    window has them on only in a cell one of whose readers reads them,
    whatever cells the benchmark has."""
    on = {}
    for w in bench.definitions()["workloads"]:
        cell = bench.cell(w["name"])
        on[w["name"]] = harness.reads_spans(cell)
        assert on[w["name"]] == any(
            getattr(bench.reader(m["name"]), "SPANS", False)
            for m in cell.per_layer), w["name"]
    assert {"train-bf16-default": True, "train-bf16-ghostbn": True,
            "serve-bf16-mixed": False,
            "render-f32-frames": False}.items() <= on.items()
    for name in NEW:
        spans = getattr(bench.reader(name), "SPANS", False)
        assert spans == (not name.startswith("sine_roofline"))


F32 = {"compute_dtype": "float32", "fast_sine": False}


@pytest.mark.parametrize("cell,spans,config", [
    ("train-bf16-default", True, F32), ("serve-bf16-mixed", False, {})])
def test_a_traced_run_hands_the_readers_the_windows_spans(
        monkeypatch, cell, spans, config):
    """On the CPU (no device operations; training in float32, where the
    sound run agrees with the reference to rounding) a traced run reads
    the launch counters, hands the trace the window's program spans where
    the cell reads them and none where it does not, leaves the tracer off
    and labels its gaps with three fields."""
    from season_nerf_torch.utils import trace as tracer
    calls, programs = [], []
    enable, counters, read = tracer.enable, tracer.counters, \
        trace.read_events

    def note(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call

    def reading(events, sync, a, b, program=None, card=None):
        programs.append(list(program))
        return read(events, sync, a, b, program, card)
    monkeypatch.setattr(tracer, "enable", note("enable", enable))
    monkeypatch.setattr(tracer, "counters", note("counters", counters))
    monkeypatch.setattr(trace, "read_events", reading)
    res = harness.execute(cell, 82, 1.0, True, device="cpu",
                          overrides=small(cell, **config), age=lambda: 0.0)
    monkeypatch.undo()
    assert res["correct"] and not tracer._on and tracer.drain() == []
    assert calls == ["enable"] * spans + ["counters"] * 2
    [program] = programs
    names = {s.name for s in program}
    if spans:
        assert {"train.step", "train.backward", "siren.sine",
                "siren.batchnorm"} <= names
    else:
        assert program == []
    assert not set(NEW) & set(res["metrics"])   # no device time on the CPU
    assert all(label.count(" / ") == 2
               for label, _ in res["breakdown"]["idle_gaps"])
