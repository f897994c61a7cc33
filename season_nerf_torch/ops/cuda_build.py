"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/season_nerf_torch/lib<name>-<digest>.so`` at the repository
root, the first time it is needed.  The digest covers the source, every
header in ``csrc/`` and the sine's degree, so an edited source is rebuilt and
a library is never loaded stale or at another degree.  ``nvcc`` runs with
``-DFAST_SIN_DEGREE=<d>``, the degree ``ops/fast_math`` read from the
environment (11 unless ``FAST_SIN_DEGREE`` says 9 or 7: ``csrc/fast_sin.cuh``
is K0 inside every kernel), and with ``-Xptxas -v``; its report (registers,
shared memory, spills) is kept beside the library as
``<name>.deg<d>.ptxas.txt``.

No ``--use_fast_math``: it would turn ``sinf`` into ``__sinf``, which
loses accuracy beyond +-pi.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

from season_nerf_torch.ops.fast_math import DEGREE

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
