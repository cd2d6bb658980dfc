"""Check and time K10 (tile gather) and K11 (tile gather by bulk copies) of
the PyTorch port on one Hopper GPU, beside ``index_select``, and against an
earlier version of the package in the same process.

    python3 scripts/torch_gather_check.py [--package-root DIR] [--ptxas]
        [--compact] [--rounds 10] [--calls 5]
        [--shapes 2b,ctile128,ctile2048,7b] [--out FILE]

Needs a card, nvcc and the repo root as the working directory. Shapes, all
bf16 rows with f32 norms, ``cap`` tiles of a seeded selection in random order:

- ``2b``: ``chip_smoke.py`` phase 2b's ``compact`` selection on 1M x 128
  (IVF-1024, B = 256, nprobe 8: every one of the 1,992 tiles of 512 rows);
- ``7b``: phase 7b's on 10M x 96 (IVF-4096, B = 256, nprobe 4: 7,057 of
  19,532 tiles of 512 rows, ``_compact_params``' cap);
- ``ctile128``, ``ctile2048``: the 1M x 128 array in tiles of 128 and of
  2,048 rows, every tile.

For each shape it holds K10 and K11 to ``tile_gather_plain`` bit for bit and
times, with CUDA events, (a) each kernel alone (one call between two events,
the wrapper's host time included, as ``chip_smoke.py`` does), (b) its device
time (the call queued behind ``torch.cuda._sleep``, so the host's launch
time is hidden) and (c) in turns: ``--rounds`` rounds, each timing
``--calls`` back-to-back calls of every function, in the order parent K10,
K10, K10, parent K10, parent K11, K11, K11, parent K11, ``index_select``,
and a contiguous ``copy_`` of the same bytes (the card's copy ceiling). It
prints the medians, each kernel's ratio to ``index_select`` (median and range
over the rounds), its share of the byte bound and the TB/s it moves.

``--package-root DIR`` loads ``pqvector_tpu_torch`` from DIR (say, the parent
commit unpacked with ``git archive`` under ``build/parent``) as a second
package in this process, so both versions are timed in turns on one card.
``--ptxas`` prints ``-Xptxas -v`` for ``csrc/compact.cu`` first.
``--compact`` first times ``search(mode="compact")`` batches, where K10 runs,
of both versions in turns (``compact_batches``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name: (rows, d, ctile, cap); cap tiles of rows // ctile, seeded
SHAPES = {
    "2b": (1_019_904, 128, 512, 1992),
    "ctile128": (1_019_904, 128, 128, 7968),
    "ctile2048": (1_019_904, 128, 2048, 498),
    "7b": (10_000_384, 96, 512, 7057),
}


def load_parent(root: str):
    """``pqvector_tpu_torch`` of another checkout, as the package
    ``pqv_parent`` beside this one; its kernels build from its own sources."""
    pkg = os.path.join(os.path.abspath(root), "pqvector_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "pqv_parent", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["pqv_parent"] = mod
    spec.loader.exec_module(mod)
    importlib.import_module("pqv_parent.kernels.compact")
    return mod


def ptxas_report(_build) -> None:
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
           str(_build.CSRC / "compact.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed on compact.cu:\n{out.stdout}\n{out.stderr}")
    lines = out.stderr.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            used = " ".join(x.strip() for x in lines[i + 1: i + 4]).replace(
                "ptxas info    : ", "")
            print(f"ptxas {m.group(1)}: {used}")


def compact_batches(torch, cs, parent_pkg, rounds: int) -> dict:
    """``search(mode="compact")`` batches (B = 256, k = 10, nprobe 8) on a
    sorted bf16 searcher over seeded 1M x 128 mixture rows, IVF-1024: this
    version's and, with a parent, the parent's on the same index, in turns
    (parent, this, this, parent), five batches a call through
    ``search_loop``; their ids must be equal."""
    import pqvector_tpu_torch as pqt

    rng = np.random.default_rng(11)
    n, d, kc, b, k, nprobe = 1_000_000, 128, 1024, 256, 10, 8
    centres = rng.standard_normal((kc, d)).astype(np.float32)
    x = centres[rng.integers(0, kc, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    index = pqt.build_ivf_index(pqt.Embeddings(x, d), pqt.IvfBuildConfig(n_clusters=kc, seed=0),
                                device="cuda")
    q = x[rng.integers(0, n, b)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    q = torch.from_numpy(q).cuda()
    pkgs = {"this": pqt} if parent_pkg is None else {"parent": parent_pkg, "this": pqt}
    searchers = {name: pkg.DeviceIvfSearcher(index, x, dtype=torch.bfloat16,
                                             row_tile=cs.ROW_TILE, cluster_sorted=True)
                 for name, pkg in pkgs.items()}
    ids = {name: s.search(q, k, nprobe, "compact")[1] for name, s in searchers.items()}
    if parent_pkg is not None and not torch.equal(ids["parent"], ids["this"]):
        raise SystemExit("search(compact): the parent's ids differ from this version's")
    order = ["parent", "this", "this", "parent"] if parent_pkg is not None else ["this"]
    fns = [lambda s=searchers[name]: s.search_loop(q, k, nprobe, reps=5, mode="compact")
           for name in order]
    t = cs.interleaved_ms(fns, rounds=rounds, calls=1) / 5
    res = {}
    for name in dict.fromkeys(order):
        cols = [i for i, o in enumerate(order) if o == name]
        per = t[:, cols].ravel()
        res[name] = {"median_ms": float(np.median(per)), "min_ms": float(per.min()),
                     "max_ms": float(per.max())}
    s = searchers["this"]
    ctile, cap, _ = s._compact_params(b, nprobe, k)
    res["ctile"], res["cap"], res["nt"] = ctile, cap, int(s.emb.shape[0]) // ctile
    print(json.dumps({"compact": res}), flush=True)
    print("search(compact) 1M x 128 bf16, B = 256, nprobe 8, ms a batch in turns: "
          + ", ".join(f"{name} median {v['median_ms']:.3f} ({v['min_ms']:.3f}-"
                      f"{v['max_ms']:.3f})" for name, v in res.items()
                      if isinstance(v, dict))
          + f"; cap {cap} of {res['nt']} tiles of {ctile} rows", flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--compact", action="store_true")
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pqvector_tpu_torch.kernels import _build
    from pqvector_tpu_torch.kernels import compact as cp

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out = {}
    print(cs.card_line(), "| torch", torch.__version__, "CUDA", torch.version.cuda,
          flush=True)
    if args.ptxas:
        ptxas_report(_build)
    _build.load()
    print(f"nvcc build {_build.build_seconds:.2f} s of {_build.CSRC}", flush=True)
    parent_pkg = load_parent(args.package_root) if args.package_root else None
    parent = parent_pkg.kernels.compact if parent_pkg is not None else None
    if parent is not None:
        parent._build.load()
        print(f"parent nvcc build {parent._build.build_seconds:.2f} s of "
              f"{parent._build.CSRC}", flush=True)
    if args.compact:
        out["compact"] = compact_batches(torch, cs, parent_pkg, args.rounds)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    arrays = {}
    for name in args.shapes.split(","):
        rows, d, ctile, cap = SHAPES[name]
        if (rows, d) not in arrays:
            gen.manual_seed(rows + d)
            arrays.clear()
            arrays[(rows, d)] = (
                torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16),
                torch.randn(rows, generator=gen, device=dev))
        emb, emb_sq = arrays[(rows, d)]
        nt = rows // ctile
        sel_np = np.random.default_rng(cap).permutation(nt)[:cap].astype(np.int32)
        sel = torch.from_numpy(sel_np).to(dev)
        e3, s3, idx = emb.view(nt, -1), emb_sq.view(nt, ctile), sel.long()

        def library(e3=e3, s3=s3, idx=idx):
            return e3.index_select(0, idx), s3.index_select(0, idx)

        # the card's copy ceiling: the same bytes copied contiguously
        src_e, src_s = emb[: cap * ctile], emb_sq[: cap * ctile]
        dst_e, dst_s = torch.empty_like(src_e), torch.empty_like(src_s)

        def memcpy(src_e=src_e, src_s=src_s, dst_e=dst_e, dst_s=dst_s):
            dst_e.copy_(src_e)
            dst_s.copy_(src_s)

        want = cp.tile_gather_plain(emb, emb_sq, sel, ctile)
        fns = {"K10": lambda: cp.tile_gather(emb, emb_sq, sel, ctile),
               "K11": lambda: cp.tile_gather_dma(emb, emb_sq, sel, ctile)}
        if parent is not None:
            fns["parent K10"] = lambda: parent.tile_gather(emb, emb_sq, sel, ctile)
            fns["parent K11"] = lambda: parent.tile_gather_dma(emb, emb_sq, sel, ctile)
        for label, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise SystemExit(f"{name}: {label} differs from the plain gather")
            del got
        moved = 2.0 * cs.nbytes_of(want[0], want[1]) + sel.numel() * 4
        del want
        bound = cs.bound_of(moved, 0.0, "fp32")["bound_ms"]
        res = {"rows": rows, "d": d, "ctile": ctile, "cap": cap, "nt": nt,
               "mb_each_way": moved / 2e6, "bound_ms": bound}
        for label, fn in fns.items():
            res[f"{label}_alone_ms"] = cs.time_ms(fn)
            res[f"{label}_device_ms"] = cs.device_ms(fn)
        res["index_select_alone_ms"] = cs.time_ms(library)
        res["index_select_device_ms"] = cs.device_ms(library)
        res["copy_device_ms"] = cs.device_ms(memcpy)

        order = (["parent K10", "K10", "K10", "parent K10", "parent K11", "K11", "K11",
                  "parent K11"] if parent is not None else ["K10", "K11"])
        seq = [fns[k] for k in order] + [library, memcpy]
        rounds = cs.interleaved_ms(seq, rounds=args.rounds, calls=args.calls)
        lib_col = len(seq) - 2
        turns = {}
        for label in dict.fromkeys(order):
            cols = [i for i, k in enumerate(order) if k == label]
            t = rounds[:, cols].mean(axis=1)
            r = t / rounds[:, lib_col]
            turns[label] = {"median_ms": float(np.median(t)),
                            "vs_index_select": {"median": float(np.median(r)),
                                                "min": float(r.min()),
                                                "max": float(r.max())},
                            "bound_share": bound / float(np.median(t)),
                            "tb_s": moved / float(np.median(t)) / 1e9}
        turns["index_select"] = {"median_ms": float(np.median(rounds[:, lib_col]))}
        turns["copy_"] = {"median_ms": float(np.median(rounds[:, lib_col + 1])),
                          "tb_s": moved / float(np.median(rounds[:, lib_col + 1])) / 1e9}
        res["turns"] = turns

        out[name] = res
        print(json.dumps({name: res}), flush=True)
        line = ", ".join(f"{k} {v['median_ms']:.4f}" for k, v in turns.items())
        print(f"{name}: cap {cap} of {nt} tiles of {ctile} rows x {d} bf16, "
              f"{moved / 2e6:.1f} MB each way, bound {bound:.4f} ms; in turns (ms): {line}",
              flush=True)
        for label in ("K10", "K11"):
            t = turns[label]
            print(f"{name} {label}: alone {res[f'{label}_alone_ms']:.4f} ms, device "
                  f"{res[f'{label}_device_ms']:.4f}, in turns {t['median_ms']:.4f} "
                  f"({t['tb_s']:.2f} TB/s, {t['bound_share']:.1%} of the bound), "
                  f"/ index_select {t['vs_index_select']['median']:.3f} "
                  f"({t['vs_index_select']['min']:.3f}-{t['vs_index_select']['max']:.3f})"
                  + (f"; parent alone {res['parent ' + label + '_alone_ms']:.4f} ms, "
                     f"device {res['parent ' + label + '_device_ms']:.4f}, in turns "
                     f"{turns['parent ' + label]['median_ms']:.4f}"
                     if parent is not None else ""), flush=True)
        print(f"{name} index_select: alone {res['index_select_alone_ms']:.4f} ms, device "
              f"{res['index_select_device_ms']:.4f}; a contiguous copy_ of the same bytes: "
              f"device {res['copy_device_ms']:.4f} ms, in turns "
              f"{turns['copy_']['median_ms']:.4f} ({turns['copy_']['tb_s']:.2f} TB/s)",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
