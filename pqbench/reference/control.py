"""The control: the reference put in the program's place, one precision
step below each precision the configuration states.

* Search (bf16 storage, f32 probe and re-score with TF32 off): the probe and
  the re-score with each operand rounded to TF32's 10 mantissa bits, the
  selection over rows and queries rounded to fp8 (e4m3).
* Build (f32 rows, TF32 off): k-means and the assignment with each operand
  of a product rounded to TF32.

Sound numbers must pass their limits and the control's must not: the limits
lie between the two readings (``PERF.md``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmeans
from .exact import Layout, select_in_clusters


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to nearest even at TF32's 10 explicit mantissa bits."""
    b = x.float().contiguous().view(torch.int32)
    low = b & 0x1FFF
    up = (low > 0x1000) | ((low == 0x1000) & ((b & 0x2000) != 0))
    return ((b & ~0x1FFF) + up.to(torch.int32) * 0x2000).view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).float()


class ControlSearcher:
    """``search(q, k, nprobe) -> (distances [B, k], ids [B, k])``, as the
    program's searcher returns them."""

    def __init__(self, layout: Layout):
        self.layout = layout
        self.xs8 = fp8(layout.xs)
        self.sq8 = (self.xs8 * self.xs8).sum(dim=1)
        self.ct = tf32(layout.centroids)
        self.ct_sq = (self.ct * self.ct).sum(dim=1)

    def search(self, q: torch.Tensor, k: int, nprobe: int, mode: str = "auto"):
        del mode
        lay = self.layout
        qt = tf32(q)
        s = self.ct_sq[None, :] - 2.0 * (qt @ self.ct.T)
        probe = torch.sort(s, dim=1, stable=True)[1][:, :nprobe]
        pos = select_in_clusters(self.xs8, self.sq8, lay.offsets, fp8(q), probe, k)
        diff = tf32(lay.xs[pos.clamp_min(0)]) - qt[:, None, :]
        d2 = torch.where(pos >= 0, (diff * diff).sum(dim=2), torch.inf)
        d2, order = torch.sort(d2, dim=1, stable=True)
        pos = pos.gather(1, order)
        ids = torch.where(pos >= 0, lay.order[pos.clamp_min(0)], -1)
        return d2.sqrt(), ids


def control_build(rows: torch.Tensor, n_clusters: int, iters: int, seed: int) -> dict:
    """The reference's build in TF32 -> a payload as ``payload.read_payload``
    returns it."""
    cents, a = kmeans.train(rows, n_clusters, iters, seed, rnd=tf32)
    order = torch.argsort(a, stable=True)
    sizes = torch.bincount(a, minlength=n_clusters)
    return {"dim": rows.shape[1], "centroids": cents.cpu().numpy(),
            "sizes": sizes.cpu().numpy().astype(np.int64),
            "row_ids": order.cpu().numpy().astype(np.int64)}
