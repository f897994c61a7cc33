"""The ray table resident on the device, and batches gathered from it.

The counterpart of ``season_nerf_tpu/data/dataset.py``: the [N, 22] rows
are uploaded once; a batch is a gather by indices the caller draws (the
trainer draws them from its step-keyed generator, a test passes its own).
"""

from __future__ import annotations

import torch

from season_nerf_torch.data.rays import RayTable, decode_batch


class DeviceRayDataset:
    def __init__(self, table: RayTable, device="cuda"):
        self.table = table
        self.n = len(table)
        self.rows = torch.as_tensor(table.rows, dtype=torch.float32,
                                    device=device)

    def batch(self, idx: torch.Tensor):
        """[B] row indices -> the decoded batch of their rows."""
        return decode_batch(self.rows.index_select(
            0, idx.to(self.rows.device)))
