"""Phase schedule and save points (numpy).

The counterpart of ``season_nerf_tpu/train/phases.py``.

Fixed fractions ``[0.2, 0, 0, 0.8]`` of ``max_train_steps``: phase 1 (DSM
prior on when ``jump_start``) and phase 4 (prior off).  Each
phase gets fresh optimizers and a OneCycle schedule over its own length.
Save points are log-spaced with a linear floor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

PHASE_FRACTIONS = [0.2, 0.0, 0.0]  # the rest goes to the last phase


@dataclass(frozen=True)
class Phase:
    index: int          # 1-based learning mode (1..4)
    start: int
    end: int
    use_prior: bool

    @property
    def length(self):
        return self.end - self.start


def build_phases(max_train_steps: int, jump_start: bool = True
                 ) -> List[Phase]:
    starts = np.cumsum([0] + [int(f * max_train_steps)
                              for f in PHASE_FRACTIONS])
    ends = list(starts[1:]) + [max_train_steps]
    phases = []
    for i, (s, e) in enumerate(zip(starts, ends)):
        if e <= s:
            continue
        phases.append(Phase(index=i + 1, start=int(s), end=int(e),
                            use_prior=(i == 0 and jump_start)))
    return phases


def output_locations(n_steps: int, n_outputs: int, min_gap: int = 1000):
    """Log-spaced save points that are never closer than ``min_gap``."""
    if n_outputs <= 0:
        return np.array([n_steps])
    if n_outputs * min_gap >= n_steps:
        return np.unique(np.linspace(1, n_steps, n_outputs + 1,
                                     dtype=int)[1:])
    alpha = np.log(n_steps) / np.log(n_outputs)
    ans = (np.arange(1, n_outputs + 1) ** alpha).astype(int)
    ans[-1] = n_steps
    lin = np.arange(1, n_outputs + 1) * min_gap
    return np.unique(np.maximum(ans, lin))


def save_points(phases: List[Phase], n_saves: int, max_train_steps: int,
                min_gap: int = 1000):
    """Each phase's save points merged into one sorted global list."""
    total = max(sum(p.length for p in phases), 1)
    pts = []
    for p in phases:
        n = int(round(n_saves * p.length / total))
        if n > 0:
            pts.extend((p.start + output_locations(p.length, n,
                                                   min_gap)).tolist())
    pts.append(max_train_steps)
    return sorted(set(int(x) for x in pts))


def phase_at(phases: List[Phase], step: int) -> Phase:
    for p in phases:
        if p.start <= step < p.end:
            return p
    return phases[-1]
