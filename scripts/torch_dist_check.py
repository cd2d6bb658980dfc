"""Slice 10 (``pqvector_tpu_torch/dist``) alone: ``chip_smoke.py``'s phase 10.

    python3 scripts/torch_dist_check.py                   # the card, 1M x 128
    python3 scripts/torch_dist_check.py --distinct-cards  # every card

It sets up what phase 10 takes from ``chip_smoke.py``'s phase 3 through the
same functions (``write_rows``: the seeded 1M x 128 rows written and read
back as Parquet; ``build_inplace`` of IVF-1024 on the card;
``phase3_serve``: the f32 exact truth for the 256 seeded queries and the
nprobe sweep of ``search(auto)`` to recall@10 >= 0.95), takes the recall at
nprobe 8, then runs phase 10: the sharded build and Lloyd, and the three
sharded searchers on four shards of one card, each kernel's launches
counted from 0. ``--distinct-cards`` runs only its part for a machine of
several cards: the mesh of every card against as many shards of the first
card. Prints the phase's lines, its JSON and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--distinct-cards", action="store_true",
                        help="only the mesh of every card against one card's shards")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import pqvector_tpu_torch as pqt
    from pqvector_tpu_torch import datasets as ds
    from pqvector_tpu_torch.kernels import _build

    cs.check(torch.cuda.is_available(), "no CUDA device")
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    data_dir = os.path.join(ROOT, "data", "torch_dist_check")
    try:
        path, emb_np, queries = cs.write_rows(ds, data_dir)
        index = pqt.IndexBuilder(path, "embedding", device=dev).n_clusters(
            cs.N_CLUSTERS).build_inplace()
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    q = torch.from_numpy(queries).to(dev)
    truth_s, truth, searcher, chosen, _ = cs.phase3_serve(torch, pqt, _build, ds, index,
                                                          emb_np, q, dev)
    r8 = cs.recall_of(ds, truth[1].cpu().numpy(), searcher.search(q, cs.K, 8, "auto")[1])
    del truth_s, searcher
    torch.cuda.empty_cache()
    if args.distinct_cards:
        from pqvector_tpu_torch import dist

        out = cs.phase10_distinct(torch, pqt, dist, emb_np, queries, truth, index, chosen)
    else:
        out = cs.phase10(torch, pqt, _build, ds, emb_np, queries, q, truth, index, r8,
                         chosen, card, device=dev)
    print("slice 10 path: " + json.dumps(out))
    print(card)


if __name__ == "__main__":
    main()
