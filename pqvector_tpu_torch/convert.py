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
    "compact_slack", "xbin_bins", "xbin_chunk_groups", "tilescan_chunk_rows",
    "loop_rescore", "weather_ttl_s",
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


#: A JAX distributed searcher's row-sharded arrays, by the port's names.
DIST_ARRAYS = ("emb", "_emb_ref", "emb_sq", "emb_sq_pallas", "gids", "tables", "lcl", "tc")


def dist_searcher_state_from_reference(
    reference, device: str | torch.device | None = None
) -> dict[str, list[torch.Tensor] | None]:
    """Per-shard tensors on ``device`` from a JAX distributed searcher
    (``DistributedIvfSearcher`` or ``DistributedClusterIvfSearcher``),
    in the port's layout: each of ``DIST_ARRAYS`` that the searcher holds,
    split into one row block per device of its mesh (None where it holds
    none). The cluster tables and tile tables become int32 (``lcl`` is f32
    there); ``tc`` loses the JAX package's padding to 128 lanes, keeping
    the largest distinct-cluster count of a tile, the port's width."""
    device = resolve_device(device)
    n_dev = int(np.asarray(reference.mesh.devices).size)
    out: dict[str, list[torch.Tensor] | None] = {}
    for name in DIST_ARRAYS:
        a = getattr(reference, name, None)
        if a is None:
            out[name] = None
            continue
        a = np.asarray(a)
        if name in ("gids", "tables", "lcl", "tc"):
            a = a.astype(np.int32)
        if name == "tc":
            a = a[:, : int(np.asarray(reference.lcl).max()) + 1]
        out[name] = [_tensor(part, device) for part in np.split(a, n_dev)]
    return out
