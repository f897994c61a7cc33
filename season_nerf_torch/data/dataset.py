"""The ray table resident on the device, and batches gathered from it.

The counterpart of ``season_nerf_tpu/data/dataset.py``: the [N, 22] rows
are uploaded once; a batch is a gather by indices the caller draws (the
trainer draws them from its step-keyed generator, a test passes its own).
On a training mesh every rank holds the whole table (replicated, as the
JAX package shards it) and gathers its own rows of the global batch.
The ranks receive the table from the process that prepared the site
through :func:`shared_table`: its arrays in shared memory, handed over by
a handle rather than pickled for each rank (a real site's table is
gigabytes).
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


def shared_table(table: RayTable) -> dict:
    """``table`` with its rows and image ids as CPU tensors in shared
    memory: what the launcher passes to the ranks by handle."""
    def share(a):
        t = torch.from_numpy(a)
        return torch.empty_like(t).share_memory_().copy_(t)

    return {"rows": share(table.rows), "img_ids": share(table.img_ids),
            "img_names": list(table.img_names), "img_sizes": table.img_sizes,
            "sun_vecs": table.sun_vecs, "time_encs": table.time_encs}


def as_table(table) -> RayTable:
    """A ``RayTable`` from itself or from :func:`shared_table`'s handle (its
    arrays views of the shared memory)."""
    if isinstance(table, RayTable):
        return table
    return RayTable(table["rows"].numpy(), table["img_ids"].numpy(),
                    table["img_names"], table["img_sizes"],
                    table["sun_vecs"], table["time_encs"])
