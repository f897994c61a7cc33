"""Metric logging as JSON lines (``metrics.jsonl``), one object a scalar.

The JSON half of ``season_nerf_tpu/utils/logging.py``'s ``MetricWriter``,
with the same tags (``Training/<name>``, ``Testing/<name>``) and record
keys.  An empty ``logdir`` makes a writer that writes nothing.  The
TensorBoard half is not ported yet, so :meth:`MetricWriter.image`, which
writes only there, writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, logdir: str):
        self.logdir = logdir
        self._jsonl = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value, step: int):
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag,
                                      "value": float(value),
                                      "step": int(step)}) + "\n")

    def scalars(self, prefix: str, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def image(self, tag: str, img, step: int):
        """img: [H, W, C] float in [0, 1] or [H, W].  The JAX package
        writes images only to TensorBoard, which the port does not write
        yet: nothing is written."""

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
