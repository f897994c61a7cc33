"""Grid-MRF energy minimization: a ctypes binding to the native
alpha-expansion solver of ``native/graph_cut.cc``.

The counterpart of ``season_nerf_tpu/priors/graph_cut.py``.  The port
builds its own copy of the library from that source the first time it is
needed, with the flags of ``native/Makefile`` (``$CXX``, default ``g++``),
into ``build/season_nerf_torch/libseason_native-<digest>.so`` at the
repository root; the digest covers the source, the flags and the CPU
(``-march=native``), so an edited source, or a checkout copied to another
machine, builds anew.  It never writes into ``native/``.

There is no fallback: where the library does not build or load,
:func:`aexpansion_grid` and :func:`grid_energy` raise.  Iterated
conditional modes (:func:`_icm`), another algorithm with other labels,
stays an explicit function of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "graph_cut.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "season_nerf_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native",
             "-shared")

_lib: Optional[ctypes.CDLL] = None


def _cpu_key() -> bytes:
    """The CPU's model and feature flags, which ``-march=native`` code
    depends on."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = {l for l in f if l.startswith(("model name", "flags"))}
        return "".join(sorted(lines)).encode()
    except OSError:
        return platform.processor().encode()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_key())
    return BUILD_DIR / f"libseason_native-{h.hexdigest()[:12]}.so"


def build_library() -> Path:
    """Compile ``native/graph_cut.cc`` unless its current library exists ->
    the library's path.  Raises RuntimeError when the compiler is missing
    or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the graph cut "
                           f"builds {SOURCE} with it (set CXX)")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (rc {res.returncode}):"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The solver's library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        args = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32)]
        lib.season_aexpansion_grid.restype = ctypes.c_double
        lib.season_aexpansion_grid.argtypes = args + [ctypes.c_int]
        lib.season_grid_energy.restype = ctypes.c_double
        lib.season_grid_energy.argtypes = args
        _lib = lib
    return _lib


def truncated_linear_costs(n_labels: int, height: float = 1.0 / 3.0,
                           start: int = 0, end: int = -1) -> np.ndarray:
    """Pairwise label costs: slope * (|i - j| - start) clamped to [0,
    height], the slope reaching ``height`` at ``end``."""
    if end == -1:
        end = n_labels - 1
    d = np.abs(np.arange(n_labels)[:, None] - np.arange(n_labels)[None, :])
    slope = height / max(end - start, 1)
    return np.clip((d - start) * slope, 0.0, height).astype(np.float32)


def _args(data_cost, smooth, labels):
    """C-contiguous float32 / int32 copies and their pointers, checked."""
    data = np.ascontiguousarray(data_cost, np.float32)
    sm = np.ascontiguousarray(smooth, np.float32)
    lab = np.ascontiguousarray(labels, np.int32)
    H, W, L = data.shape
    if sm.shape != (L, L) or lab.shape != (H, W):
        raise ValueError(f"data cost {data.shape}, smoothness {sm.shape}, "
                         f"labels {lab.shape} do not agree")
    if lab.size and (lab.min() < 0 or lab.max() >= L):
        raise ValueError(f"labels outside [0, {L})")
    f32 = ctypes.POINTER(ctypes.c_float)
    ptrs = (data.ctypes.data_as(f32), sm.ctypes.data_as(f32), H, W, L,
            lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return data, sm, lab, ptrs


def aexpansion_grid(data_cost: np.ndarray, smooth: np.ndarray,
                    init_labels: Optional[np.ndarray] = None,
                    max_cycles: int = 3) -> Tuple[np.ndarray, float]:
    """Minimize sum_p D[p, l_p] + sum over 4-neighbours V[l_p, l_q] by
    alpha-expansion from ``init_labels`` (default: the per-pixel argmin).
    data_cost [H, W, L], smooth [L, L] a metric -> (labels [H, W], energy).
    """
    data = np.ascontiguousarray(data_cost, np.float32)
    labels = np.argmin(data, axis=2) if init_labels is None else init_labels
    lib = load_library()
    data, sm, lab, ptrs = _args(data, smooth, np.array(labels))
    energy = lib.season_aexpansion_grid(*ptrs, max_cycles)
    return lab, float(energy)


def grid_energy(data_cost, smooth, labels) -> float:
    lib = load_library()
    data, sm, lab, ptrs = _args(data_cost, smooth, labels)
    return float(lib.season_grid_energy(*ptrs))


def _energy_np(data, sm, lab):
    H, W, _ = data.shape
    e = data[np.arange(H)[:, None], np.arange(W)[None, :], lab].sum()
    e += sm[lab[:, :-1], lab[:, 1:]].sum()
    e += sm[lab[:-1, :], lab[1:, :]].sum()
    return float(e)


def _icm(data, sm, labels, sweeps=10):
    """Iterated conditional modes: greedy per-pixel moves until none
    changes a label or ``sweeps`` run out -> (labels, energy)."""
    H, W, L = data.shape
    lab = labels.copy()
    for _ in range(sweeps):
        changed = False
        for y in range(H):
            for x in range(W):
                cost = data[y, x].copy()
                if x > 0:
                    cost += sm[:, lab[y, x - 1]]
                if x + 1 < W:
                    cost += sm[:, lab[y, x + 1]]
                if y > 0:
                    cost += sm[:, lab[y - 1, x]]
                if y + 1 < H:
                    cost += sm[:, lab[y + 1, x]]
                best = int(np.argmin(cost))
                if best != lab[y, x]:
                    lab[y, x] = best
                    changed = True
        if not changed:
            break
    return lab, _energy_np(data, sm, lab)
