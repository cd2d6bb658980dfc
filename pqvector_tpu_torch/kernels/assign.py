"""K1: nearest-centroid assignment, ``argmin_c |c|^2 - 2 x.c`` per row.

Counterpart of ``pqvector_tpu/kernels/assign.py`` (``pallas_assign``). On
CUDA tensors ``assign_rows`` launches the hand-written kernel
(``csrc/assign.cu``, on the score tile of ``csrc/score_tile.cuh``: a block
owns 128 rows of ``x`` and walks the centroids in IEEE fp32 FMA, keeping a
running argmin in registers); on CPU tensors it runs ``assign_rows_plain``,
the same function in plain torch. Ties keep the lowest centroid index, as
``jnp.argmin`` does.

``x`` may be bf16, the resident matrix of a build under the bf16 wire: the
kernel's bf16-row form widens each element as it stages it, and the plain
version widens one block of rows at a time, so either gives the ids of the
f32 form over ``x.float()`` bit for bit without a full-size f32 copy. The
centroids are always f32.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from . import _build

#: Rows per block of the plain version: bounds its [block, k] score matrix.
_PLAIN_BLOCK = 8192


def assign_rows_plain(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[n, d] f32 or bf16 x [k, d] f32 -> [n] int32, in plain torch."""
    c_norm = (centroids * centroids).sum(dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for lo in range(0, x.shape[0], _PLAIN_BLOCK):
        scores = x[lo : lo + _PLAIN_BLOCK].float() @ centroids.T
        out[lo : lo + _PLAIN_BLOCK] = torch.argmin(
            c_norm[None, :] - 2.0 * scores, dim=1
        ).to(torch.int32)
    return out


def _assign_cuda(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    lib = _build.load()
    n, d = x.shape
    k = centroids.shape[0]
    c_norm = (centroids * centroids).sum(dim=1).contiguous()
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    entry = "pqv_assign_bf16" if x.dtype == torch.bfloat16 else "pqv_assign"
    rc = getattr(lib, entry)(
        x.data_ptr(), centroids.data_ptr(), c_norm.data_ptr(), n, d, k,
        out.data_ptr(), _build.stream_ptr(),
    )
    _build.check(rc, entry)
    _build.LAUNCHES["K1"] += 1
    if x.dtype == torch.bfloat16:
        _build.LAUNCHES["K1_bf16"] += 1
    return out


def assign_rows(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids for every row of ``x`` ([n, d] -> [n] int32).

    ``x`` is float32 or bfloat16, the centroids float32, both on one
    device. The kernel masks the ragged last block itself, so rows need no
    padding."""
    if x.dtype not in (torch.float32, torch.bfloat16) or centroids.dtype != torch.float32:
        raise TypeError("assign_rows takes float32 or bfloat16 rows and float32 centroids")
    if x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, centroids {tuple(centroids.shape)}"
        )
    if x.device != centroids.device:
        raise ValueError("x and centroids must be on one device")
    if x.device.type == "cpu":
        return assign_rows_plain(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _assign_cuda(x.contiguous(), centroids.contiguous())


def assign_clusters(
    x: np.ndarray | torch.Tensor,
    centroids: np.ndarray | torch.Tensor,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Host-friendly form: any row count in, numpy ids out (the counterpart
    of ``assign_clusters_pallas``). A bf16 tensor stays bf16."""
    device = resolve_device(device)
    bf16 = isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
    xt = torch.as_tensor(x, dtype=torch.bfloat16 if bf16 else torch.float32, device=device)
    ct = torch.as_tensor(centroids, dtype=torch.float32, device=device)
    return assign_rows(xt, ct).cpu().numpy()
