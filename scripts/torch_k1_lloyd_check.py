"""Time K1 on f32 rows at the sizes Lloyd's loop calls it, Lloyd itself and
the main path's build, in two versions of the PyTorch port in one process,
on one Hopper GPU.

    python3 scripts/torch_k1_lloyd_check.py [--package-root DIR] [--out FILE]

Needs a card, nvcc and the repo root as the working directory.

1. K1 calls. Seeded 256-mode mixture rows (the generator of
   ``scripts/torch_score_tile_check.py --sweep``), n = ``SIZES`` rows of
   d = 128 against 1024 centroids and of d = 1024 against 1000: 50,000 is
   the 5% training sample of a 1M-row build, 12,500 a shard's part of it on
   the four-shard mesh, 100,000 the sample's cap; ``F32_SCREEN_MIN_WORK``
   comes from where the versions cross. Two centroid sets: k rows of the
   data (k-means++ seeds: the loop's first call) and the centroids k-means
   trains on 50,000 rows (its last calls). Each of 10 rounds times one
   ``assign_rows`` call of each version in turns (parent, change, change,
   parent), each between two CUDA events after a warm-up, so a route's host
   syncs count; beside them the change's ``pqv_assign`` over every row
   (``route="fma"``) and its screen route, and the share of rows the screen
   leaves uncertified. The ids of both versions must be equal.
2. Lloyd. ``index.kmeans.k_means`` of each version on the first 50,000 rows
   at both widths, three rounds in turns: seconds, K1's part (every
   ``assign_rows`` call of the loop between CUDA events) and the calls;
   centroids must be equal.
3. Builds. ``IndexBuilder(...).n_clusters(1024).build_inplace()`` on copies
   of ``chip_smoke.py`` phase 3's 1M x 128 Parquet file (written under
   ``build/``), a round to warm up and two in turns: seconds and stages;
   index bytes must be equal.

``--package-root DIR`` loads ``pqvector_tpu_torch`` from DIR (say, the parent
commit unpacked with ``git archive`` under ``build/parent``) as a second
package in this process; without it only this version is timed.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((128, 1024), (1024, 1000))
SIZES = (6250, 12_500, 25_000, 50_000, 100_000, 200_000, 400_000)
ROUNDS, LLOYD_ROUNDS, BUILD_ROUNDS = 10, 3, 2


def load_parent(root: str):
    """``pqvector_tpu_torch`` of another checkout, as the package
    ``pqv_parent`` beside this one; its kernels build from its own sources."""
    pkg = os.path.join(os.path.abspath(root), "pqvector_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "pqv_parent", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["pqv_parent"] = mod
    spec.loader.exec_module(mod)
    return mod


def modules(name: str) -> dict:
    """The modules of package ``name`` this script drives."""
    return {key: importlib.import_module(f"{name}.{path}") for key, path in (
        ("ka", "kernels.assign"), ("km", "index.kmeans"), ("build", "kernels._build"),
        ("prof", "utils.profiling"))} | {"pkg": importlib.import_module(name)}


def mixture(torch, n: int, d: int):
    """[n, d] f32 seeded 256-mode mixture rows on the card, in random order."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    modes = torch.from_numpy(np.random.default_rng(1234).uniform(-1, 1, (256, d)).astype(
        np.float32)).to(dev)
    return modes[torch.randint(0, 256, (n,), device=dev, generator=gen)] + 0.15 * torch.randn(
        n, d, device=dev, generator=gen)


def one_call_ms(torch, fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def in_turns(torch, fns: dict, order: list[str], rounds: int) -> dict:
    """{name: [ms a round]}: each round one call of every function of
    ``order`` in that order (a name may appear twice), after a warm-up."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in order:
            times[name].append(one_call_ms(torch, fns[name]))
    return times


def summary(times: dict) -> str:
    out = ", ".join(f"{name} {np.median(v):.4f} ms" for name, v in times.items())
    if "parent" in times:
        p = np.array(times["parent"]).reshape(-1, 2).mean(1)
        c = np.array(times["change"]).reshape(-1, 2).mean(1)
        r = c / p
        out += f"; change / parent {np.median(r):.3f} (rounds {r.min():.3f}-{r.max():.3f})"
    return out


def k1_calls(torch, versions: dict, sizes, rounds: int, res: dict) -> None:
    change = versions["change"]
    ka = change["ka"]
    order = ["parent", "change", "change", "parent"] if "parent" in versions else ["change"]
    for d, k in SHAPES:
        rows = mixture(torch, max(max(sizes), 50_000), d)
        gen = np.random.default_rng(d + k)
        seeds = rows[torch.from_numpy(gen.permutation(rows.shape[0])[:k]).to(rows.device)]
        trained = torch.from_numpy(change["km"].k_means(
            rows[:50_000], change["km"].KMeansParams(n_clusters=k), device="cuda")[0]).to(
            rows.device)
        for cname, cent in (("seeds", seeds.contiguous()), ("trained", trained)):
            for n in sizes:
                x = rows[:n].contiguous()
                fns = {name: (lambda m=m: m["ka"].assign_rows(x, cent))
                       for name, m in versions.items()}
                fns["change fma"] = lambda: ka._assign_cuda(x, cent, route="fma")
                fns["change screen"] = lambda: ka._assign_cuda(x, cent, route="screen")
                want = fns["change fma"]()
                differ = {name: int((fns[name]() != want).sum()) for name in fns}
                if any(differ.values()):
                    raise SystemExit(f"K1 {n} x {d} x {k} {cname}: ids differ {differ}")
                ka.reset_screen_counts()
                fns["change screen"]()
                share = ka.SCREENED["f32_uncertified"] / max(1, ka.SCREENED["f32_rows"])
                route = ka.f32_route(n, d, k, x.data_ptr())
                times = in_turns(torch, fns, order + ["change fma", "change screen"], rounds)
                key = f"{n}x{d}x{k} {cname}"
                res[key] = {"route": route, "uncertified": share,
                            **{name: float(np.median(v)) for name, v in times.items()},
                            "rounds": times}
                print(f"K1 f32 {n} x {d} x {k}, {cname} centroids (route {route}, screen "
                      f"leaves {share:.5f} uncertified): {summary(times)}", flush=True)
        del rows, seeds, trained
        torch.cuda.empty_cache()


def lloyd(torch, versions: dict, rounds: int, res: dict) -> None:
    order = ["parent", "change", "change", "parent"] if "parent" in versions else ["change"]
    for d, k in SHAPES:
        sample = mixture(torch, 50_000, d)
        runs = {name: [] for name in versions}
        cents = {}
        for _ in range(rounds):
            for name in order:
                km = versions[name]["km"]
                events = []
                inner = km.assign_rows

                def timed(x, c, inner=inner, events=events):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = inner(x, c)
                    end.record()
                    events.append((start, end))
                    return out

                km.assign_rows = timed
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cents[name] = km.k_means(sample, km.KMeansParams(n_clusters=k),
                                             device="cuda")[0]
                    torch.cuda.synchronize()
                    sec = time.perf_counter() - t0
                finally:
                    km.assign_rows = inner
                k1 = sum(s.elapsed_time(e) for s, e in events)
                runs[name].append((sec, k1, len(events)))
        if "parent" in cents and not np.array_equal(cents["parent"], cents["change"]):
            raise SystemExit(f"Lloyd 50000 x {d} x {k}: centroids differ")
        out = {}
        for name, v in runs.items():
            secs, k1s, calls = zip(*v)
            out[name] = {"s": list(secs), "k1_ms": list(k1s), "calls": calls[0]}
        res[f"lloyd 50000x{d}x{k}"] = out
        print(f"Lloyd 50000 x {d} x {k}: " + "; ".join(
            f"{name} {np.median(o['s']):.4f} s (runs " + ", ".join(f"{s:.4f}" for s in o["s"])
            + f"), K1 {np.median(o['k1_ms']):.3f} ms in {o['calls']} calls (runs "
            + ", ".join(f"{t:.3f}" for t in o["k1_ms"]) + ")" for name, o in out.items()),
            flush=True)
        del sample
        torch.cuda.empty_cache()


def builds(torch, cs, versions: dict, rounds: int, res: dict) -> None:
    from pqvector_tpu_torch import datasets as ds

    order = ["parent", "change", "change", "parent"] if "parent" in versions else ["change"]
    data_dir = os.path.join(ROOT, "build", "k1_lloyd_data")
    path = cs.write_rows(ds, data_dir)[0]
    runs = {name: [] for name in versions}
    digests = set()
    try:
        for r in range(rounds + 1):  # the first round warms both up
            for name in order:
                m = versions[name]
                copy = os.path.join(data_dir, f"{name}_{r}.parquet")
                shutil.copy(path, copy)
                m["prof"].drain_stages()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                index = m["pkg"].IndexBuilder(copy, "embedding", device="cuda").n_clusters(
                    1024).build_inplace()
                sec = time.perf_counter() - t0
                stages = dict(m["prof"].drain_stages())
                digests.add(hashlib.sha256(index.to_bytes()).hexdigest()[:16])
                os.remove(copy)
                if r:
                    runs[name].append({"s": sec, **stages})
                print(f"build_inplace 1M x 128 IVF-1024, {name}{'' if r else ' (warm-up)'}: "
                      f"{sec:.3f} s; " + ", ".join(f"{key} {v:.3f} s"
                                                  for key, v in stages.items()), flush=True)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    if len(digests) != 1:
        raise SystemExit(f"index bytes differ between builds: {digests}")
    res["build 1Mx128 IVF-1024"] = runs
    print(f"build_inplace 1M x 128 IVF-1024: index bytes {digests.pop()} in every build",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), "| torch", torch.__version__, "CUDA", torch.version.cuda,
          flush=True)
    versions = {"change": modules("pqvector_tpu_torch")}
    if args.package_root:
        load_parent(args.package_root)
        versions = {"parent": modules("pqv_parent"), **versions}
    for name, m in versions.items():
        m["build"].load()
        print(f"{name} nvcc build {m['build'].build_seconds:.2f} s of {m['build'].CSRC}",
              flush=True)
    res = {"card": cs.card_line()}
    k1_calls(torch, versions, SIZES, ROUNDS, res)
    lloyd(torch, versions, LLOYD_ROUNDS, res)
    builds(torch, cs, versions, BUILD_ROUNDS, res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f)
    print("ok")


if __name__ == "__main__":
    main()
