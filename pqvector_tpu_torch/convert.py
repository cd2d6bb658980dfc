"""Carry state from the JAX package into this one.

Both take plain numpy arrays, so this module imports neither JAX nor the
JAX package: a caller hands over ``np.asarray`` of the JAX objects' fields.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .index.ivf import IvfIndex


def index_from_reference(
    centroids: np.ndarray, list_offsets: np.ndarray, row_ids: np.ndarray
) -> IvfIndex:
    """The port's ``IvfIndex`` from the JAX package's index arrays."""
    centroids = np.asarray(centroids, dtype=np.float32)
    n_clusters, dim = centroids.shape
    return IvfIndex(
        dim=dim,
        n_clusters=n_clusters,
        centroids=centroids,
        list_offsets=np.asarray(list_offsets, dtype=np.int64),
        row_ids=np.asarray(row_ids, dtype=np.uint32),
    )


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, as JAX hands it out
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def searcher_state_from_reference(
    arrays: dict[str, np.ndarray | None],
    device: str | torch.device | None = None,
) -> dict[str, torch.Tensor | None]:
    """Tensors on ``device`` from a JAX searcher's arrays.

    ``arrays`` maps a JAX searcher's attribute names (``emb``, ``emb_sq``,
    ``_emb_ref``, ``centroids``, ``c_sq``, ``clusters``, ``row_cluster``,
    ``_gid``, and the int8 modes' ``_emb_i8`` codes and ``_emb_i8_scale``)
    and its tile tables (``local_cluster``, ``tile_clusters``) to numpy
    arrays, or to None where the JAX searcher holds none. Cluster ids that
    the JAX package ships as f32 (``local_cluster``, a Mosaic workaround)
    become int32; int8 codes stay int8."""
    device = resolve_device(device)
    out: dict[str, torch.Tensor | None] = {}
    for name, a in arrays.items():
        if a is None:
            out[name] = None
            continue
        t = _tensor(a, device)
        if name in ("local_cluster", "tile_clusters", "clusters", "row_cluster", "_gid"):
            t = t.to(torch.int32)
        out[name] = t
    return out


#: Serving knobs that both packages' searchers carry under one name.
SEARCHER_KNOBS = (
    "approx_recall_target", "approx_score_dtype", "scan_overfetch",
    "tilescan_tile", "cert_fetch_tiles", "cert_pass1", "cert_pass2",
    "compact_slack",
)


def copy_searcher_knobs(reference, searcher) -> None:
    """Set ``searcher``'s serving knobs (``SEARCHER_KNOBS``) to those of a
    JAX searcher, so that both compute the same thing. ``reference`` is any
    object with those attributes; its ``approx_score_dtype`` (a numpy-style
    float32 or bfloat16 type) becomes the torch dtype of that name."""
    for name in SEARCHER_KNOBS:
        value = getattr(reference, name)
        if name == "approx_score_dtype":
            value = getattr(torch, np.dtype(value).name)
        setattr(searcher, name, value)
