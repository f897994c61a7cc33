"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` names the cell; its configuration, traffic mix,
limits and per-layer readers are files found by name (``bench.py``).
Set-up (process start to the first timed call) makes every input from
the seed, builds the program's objects and warms each shape the window
uses; the window then runs for ``--seconds``.  With ``--trace 1`` the
window runs under ``torch.profiler``: the readers get the profiler's
trace (``run.trace``, its device time by kernel name and by the program
span that launched it), the benchmark's host spans (``run.spans``), the
window's deltas of the program's launch counters (``run.counts``), and,
where a reader of the cell reads them (its module's ``SPANS``), the
program's spans of the window (``run.program_spans``; the port's tracer,
``season_nerf_torch.utils.trace``, is on for the window only then).  The
line carries the per-layer metrics, the device's busy seconds and a
breakdown.  With ``--trace 0`` the line carries the end-to-end metrics,
and the run imports, enables and reads nothing of the program's tracer.
After the window the program's state is freed and the plain reference
(``reference/``) judges what the timed path produced; each number
compared is printed beside its limit, last on standard error and last in
the result's line, which is the last line of standard output.

Cards and processes.  A cell of ``chips`` n runs on cards 0..n-1.  This
process is the one whose window is timed and traced, so a kind whose
work spans processes runs one rank of it here, rank 0 on ``cuda:0``, and
keeps the processes that run the others in ``run.children``:

- ``memory_peak_bytes`` is the fullest card's: the largest of this
  process's ``max_memory_allocated`` on each of cards 0..n-1, and of what
  the kind reports in ``run.peaks`` (card index -> bytes) for the cards
  that other processes drive;
- the trace is this process's: ``busy_s``, the idle shares and the idle
  gaps are those of ``run.device``'s card, while device time by kernel
  name or program span sums all that this process launched
  (``trace.py``);
- a child in ``run.children`` that exits with another code than 0, in
  set-up, the window or the check, ends the run within a second: the
  other children are ended, no result is printed and the process exits
  with ``CHILD_DIED`` (a rank left alone would wait in a collective for
  the mesh's timeout).

On a one-card cell whose kind starts no rank, these are the card's
peak, its trace and nothing to watch.

Exits with another code than 0, printing no result, without a card (or
with fewer than the cell asks for), without the program beside this
folder, when a child dies as above, or when the process holds ``jax``,
``jaxlib``, ``flax`` or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import bench, trace  # noqa: E402

# the compile caches any library may keep, at fixed places in the
# checkout (the port keeps its own libraries under build/season_nerf_torch)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "extensions",
          "CUDA_CACHE_PATH": "nv"}
CHILD_DIED = 4          # the exit code of a run ended by a child's death
WATCH_S = 0.25          # how often the children are looked at


def process_age() -> float:
    """Seconds since this process started (from /proc), or since this
    module was loaded where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T0


class Run:
    """One run of one cell: its definitions, its seed and what its kind
    of traffic records."""

    def __init__(self, cell: bench.Cell, seed: int, seconds: float,
                 device, faults=None, age=process_age):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.age, self.marks = age, []
        self.config, self.traffic = cell.config, cell.traffic
        self.device = device
        self.faults = faults or {}
        self.spans = trace.Spans()
        self.end_to_end, self.work = {}, {}
        self.attempted = self.failed = 0
        self.program = self.trace = None
        self.program_spans = self.counts = None
        self.cleanup, self.children, self.stops = [], [], []
        self.peaks = {}         # card -> peak bytes of another process
        self._closing = threading.Event()
        self._watcher = None

    def mark(self, name: str):
        """Note the process's age as set-up reaches ``name``."""
        self.marks.append((name, self.age()))

    def watch(self):
        """Until :meth:`close`, end the process when a child dies: a
        thread looks at ``children`` every ``WATCH_S`` seconds, and on one
        that has exited with another code than 0 ends the others, removes
        ``cleanup`` and exits with ``CHILD_DIED``.  The process cannot wait
        for its main thread, which may be blocked in a collective that
        only the mesh's timeout ends."""
        def look():
            while not self._closing.wait(WATCH_S):
                dead = self._dead()
                if dead:
                    print(f"portbench: {dead}; ending the run",
                          file=sys.stderr, flush=True)
                    self._end_children()
                    self._remove()
                    os._exit(CHILD_DIED)
        self._watcher = threading.Thread(target=look, daemon=True)
        self._watcher.start()

    def _dead(self) -> str:
        """Which children have exited with another code than 0."""
        codes = [(c, c.poll()) for c in self.children]
        return "; ".join(f"child {c.pid} ({str(c.args)[:120]}) exited "
                         f"with code {rc}" for c, rc in codes
                         if rc not in (None, 0))

    def _end_children(self):
        for child in self.children:
            if child.poll() is None:
                child.kill()
            child.wait()

    def _remove(self):
        for d in self.cleanup:
            shutil.rmtree(d, ignore_errors=True)

    def close(self):
        """Stop the watch, the kind's services and every child; raises
        if a child had exited with another code than 0."""
        self._closing.set()
        if self._watcher is not None:
            self._watcher.join()
        for stop in self.stops:
            stop()
        dead = self._dead()
        self._end_children()
        self._remove()
        if dead:
            raise RuntimeError(dead)


def import_program():
    """The port from this checkout, or an ImportError."""
    import season_nerf_torch
    where = os.path.dirname(os.path.abspath(season_nerf_torch.__file__))
    if where != os.path.join(ROOT, "season_nerf_torch"):
        raise ImportError(f"season_nerf_torch comes from {where}, not "
                          f"from {ROOT}")


def port_tracer():
    """The port's tracer (``season_nerf_torch.utils.trace``), or None on a
    port without one."""
    try:
        from season_nerf_torch.utils import trace as tracer
    except ImportError:
        return None
    return tracer


def reads_spans(cell: bench.Cell) -> bool:
    """Whether a per-layer reader of ``cell`` reads the program's spans:
    they cost the host some microseconds each, so a cell whose readers
    read none runs its traced window with them off."""
    return any(getattr(bench.reader(m["name"]), "SPANS", False)
               for m in cell.per_layer)


@contextlib.contextmanager
def program_spans(run: Run, tracer, spans: bool):
    """Around the block, the port's launch counters read and, with
    ``spans``, its spans on: afterwards ``run.counts`` holds each
    counter's delta over the block and ``run.program_spans`` the spans
    that ended in it (none with ``spans`` off)."""
    if tracer is None:
        yield
        return
    kept = []
    if spans:
        tracer.drain()
        tracer.enable()
    try:
        before = tracer.counters()
        yield
        after = tracer.counters()
    finally:
        if spans:
            kept = tracer.drain()
            tracer.disable()
    run.program_spans = kept
    run.counts = {k: v - before.get(k, 0) for k, v in after.items()}


def guard():
    found = bench.banned_modules(list(sys.modules))
    if found:
        raise RuntimeError(f"the process holds {found}")


def execute(name: str, seed: int, seconds: float, traced: bool,
            device="cuda", modes=("program",), faults=None,
            overrides=None, age=process_age) -> dict:
    """One run of the cell ``name`` -> the result's dict, judged on the
    first of ``modes``: "program", or "control" (the reference at the
    precision below the configuration's in the program's place); every
    mode's numbers go under "readings".  ``faults`` and ``overrides``
    (keys of the configuration and of the mix) serve the tests."""
    import torch
    cell = bench.cell(name)
    for key, part in (overrides or {}).items():
        getattr(cell, key).update(part)
    kind = bench.kind(cell.traffic)
    dev = torch.device(device)
    run = Run(cell, seed, seconds, dev, faults, age)
    try:
        run.watch()
        import_program()
        run.mark("program imported")
        kind.setup(run)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = age()
        print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                     run.marks + [("warm", setup_s)]),
              file=sys.stderr)
        holder = {}
        with program_spans(run, port_tracer() if traced else None,
                           reads_spans(cell)), \
                trace.traced(traced, holder):
            kind.window(run)
        guard()
        peak = memory_peak(run)
        metrics = {}
        if traced:
            run.trace = holder["read"](*run.window_span, run.program_spans,
                                       card(dev))
            for m in cell.per_layer:
                v = bench.reader(m["name"]).read(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in cell.end_to_end:
                if m["name"] in run.end_to_end:
                    v, unit = run.end_to_end[m["name"]]
                    metrics[m["name"]] = {"value": v, "unit": unit}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        kind.release(run)
        readings = kind.check(run, modes)
        numbers = readings[modes[0]]
    finally:
        run.close()
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items() if k in cell.limits}
    correct = (run.failed == 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info(dev, cell.chips, peak, run.trace)}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown(run.spans)
    result["readings"] = numbers if len(modes) == 1 else readings
    result["checks"] = checks
    return result


def card(dev):
    """The index of the card ``dev`` names (None off CUDA)."""
    import torch
    if dev.type != "cuda":
        return None
    return torch.cuda.current_device() if dev.index is None else dev.index


def memory_peak(run) -> int:
    """The fullest card's peak: this process's on each of the cell's
    cards, and the kind's ``run.peaks`` for the cards other processes
    drive (a card this process never touched reads 0)."""
    import torch
    mine = ([torch.cuda.max_memory_allocated(i)
             for i in range(run.cell.chips)]
            if run.device.type == "cuda" else [])
    return int(max(mine + list(run.peaks.values()) + [0]))


def device_info(dev, chips: int, peak: int, tr) -> dict:
    import torch
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        info["busy_s"], info["window_s"] = tr.busy_s, tr.window_s
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = bench.cell(args.workload)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} on {torch.cuda.get_device_name(0)}",
          file=sys.stderr)
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    found = bench.banned_modules(list(sys.modules))
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 3
    for k, v in result["readings"].items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
