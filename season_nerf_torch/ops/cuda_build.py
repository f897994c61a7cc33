"""Build the port's CUDA sources with ``nvcc``, load them with ``ctypes``,
and bind their C functions (:class:`Library`).

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/season_nerf_torch/lib<name>-<digest>.so`` at the repository
root, the first time it is needed.  The digest covers the source, every
header in ``csrc/`` and the sine's degree, so an edited source is rebuilt and
a library is never loaded stale or at another degree.  ``nvcc`` runs with
``-DFAST_SIN_DEGREE=<d>``, the polynomial sine's degree (:data:`DEGREE`,
read from the environment when this module is imported: 11 unless
``FAST_SIN_DEGREE`` says 9 or 7; ``csrc/fast_sin.cuh`` is K0 inside every
kernel, and ``ops/fast_math`` takes its plain version's polynomial by it),
and with ``-Xptxas -v``; its report (registers, shared memory, spills) is
kept beside the library as ``<name>.deg<d>.ptxas.txt``.

No ``--use_fast_math``: it would turn ``sinf`` into ``__sinf``, which
loses accuracy beyond +-pi.

Every ops module reaches its library through a :class:`Library`: it names
the C functions it calls and their argument types once, as data, and
:meth:`Library.launch` runs one on a card's current stream, raises with
the library's own ``<name>_error_string`` and counts the launch into a
counter of ``utils/trace``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Sequence

import torch

from season_nerf_torch.utils import trace

_DEGREE = os.environ.get("FAST_SIN_DEGREE", "11")
if _DEGREE not in ("11", "9", "7"):
    raise ValueError(
        f"FAST_SIN_DEGREE={_DEGREE!r}: valid degrees are [7, 9, 11]")
DEGREE = int(_DEGREE)
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "season_nerf_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DFAST_SIN_DEGREE={DEGREE}")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels build on a machine with the CUDA "
                       "toolkit)")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(f"FAST_SIN_DEGREE={DEGREE}".encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _ptxas_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.deg{DEGREE}.ptxas.txt"


def ptxas_report(name: str) -> str:
    path = _ptxas_path(name)
    return path.read_text() if path.exists() else ""


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` per source, all started together.  Raises with the compiler's
    output if any fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, lib in paths.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        _ptxas_path(n).write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]


class Library:
    """The C functions of ``csrc/<name>.cu`` that an ops module calls.

    ``signatures`` maps each function's name to its arguments' ctypes, as
    its C prototype lists them; each returns an ``int`` (a launch's
    ``cudaError_t``, or a count).  The library is built, loaded and bound
    on the first call, and every function resolved once."""

    def __init__(self, name: str, signatures: Mapping[str, Sequence]):
        self.name = name
        self._signatures = signatures
        self._fns: Optional[dict] = None

    def _bind(self) -> dict:
        lib = load(self.name)
        fns = {}
        for fn, argtypes in self._signatures.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(argtypes), ctypes.c_int
            fns[fn] = f
        err = getattr(lib, f"{self.name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        self._error_string = err
        self._fns = fns
        return fns

    def call(self, fn: str, *args) -> int:
        """``fn(*args)``, a tensor passed as its pointer: for the functions
        that launch nothing (a launch's grid, a tensor map)."""
        return (self._fns or self._bind())[fn](
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args))

    def launch(self, fn: str, device, *args, counter: Optional[str] = None,
               context=None) -> None:
        """``fn(*args, stream)`` on ``device``'s current stream, a tensor
        passed as its pointer.  Raises ``RuntimeError`` on an error, with
        the library's text and ``context``; counts one launch into the
        tracer's ``counter``, if given."""
        f = (self._fns or self._bind())[fn]
        with torch.cuda.device(device):     # launch on the tensors' card
            err = f(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                      for a in args),
                    torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} {fn} failed: "
                f"{self._error_string(err).decode()}"
                + ("" if context is None else f" ({context})"))
        if counter is not None:
            trace.count(counter)
