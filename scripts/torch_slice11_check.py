"""Slice 11 alone: ``chip_smoke.py``'s phase 11.

    python3 scripts/torch_slice11_check.py

It sets up what phase 11 takes from ``chip_smoke.py``'s phase 3 through the
same functions (``write_rows``: the seeded 1M x 128 rows written and read
back as Parquet; ``build_inplace`` of IVF-1024 on the card;
``phase3_serve``: the f32 exact truth for the 256 seeded queries and the
nprobe sweep of ``search(auto)`` to recall@10 >= 0.95), then runs phase 11:
the packed-key scans (``xbin``, ``xbin8``, ``tilescan``) at B = 256 and
4096, ``autoscan`` with the card's weather report and injected ones, the
loops' deferred re-score, and the sharded ``search_xbin``/``search_xbin8``
on four shards of the card, launch counts from 0. Prints the phase's lines,
its JSON and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import pqvector_tpu_torch as pqt
    from pqvector_tpu_torch import datasets as ds
    from pqvector_tpu_torch.kernels import _build

    cs.check(torch.cuda.is_available(), "no CUDA device")
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    data_dir = os.path.join(ROOT, "data", "torch_slice11_check")
    try:
        path, emb_np, queries = cs.write_rows(ds, data_dir)
        index = pqt.IndexBuilder(path, "embedding", device=dev).n_clusters(
            cs.N_CLUSTERS).build_inplace()
        q = torch.from_numpy(queries).to(dev)
        truth_s, truth, searcher, chosen, _ = cs.phase3_serve(torch, pqt, _build, ds, index,
                                                              emb_np, q, dev)
        del truth_s, searcher
        torch.cuda.empty_cache()
        out = cs.phase11(torch, pqt, _build, ds, path, emb_np, queries, q, truth, index,
                         chosen, card, device=dev)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    print("slice 11 path: " + json.dumps(out))
    print(card)


if __name__ == "__main__":
    main()
