"""Slice 12 alone: ``chip_smoke.py``'s phase 12, and the kernel cache's
cold build against a warm load.

    python3 scripts/torch_slice12_check.py [--no-cache-check]

It sets up what phase 12 takes from ``chip_smoke.py`` through the same
functions (``write_rows``: the seeded 1M x 128 rows written and read back as
Parquet; ``build_inplace`` of IVF-1024 on the card), holds K1's f32 and
bf16-row forms to their plain versions on phase 2a's small grid cases, then
runs phase 12: the wires on that file, the 1M x 1024 builds (f32, bf16,
int8, bf16 with the host assignment, bf16 again; the device ones again
through ``pqv_assign`` alone, the same bytes), K1's bf16-row form and its
f32-row route at 1M x 1024 x 1000, the host assignment against K1 f32,
recall@100 of sorted
searchers on the f32- and bf16-wire indexes, and the examples on the card
and the CPU. Then, unless ``--no-cache-check``, three fresh processes load
the kernel library: one under ``PQVECTOR_TPU_NO_COMPILE_CACHE=1`` (a cold
nvcc build in a directory of its own), two from the default cache
directory (warm); each prints its seconds. Prints the phase's lines, its
JSON and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOAD = ("import time; t0 = time.perf_counter(); import torch; "
         "from pqvector_tpu_torch.kernels import _build; t1 = time.perf_counter(); "
         "torch.cuda.init(); _build.load(); t2 = time.perf_counter(); "
         "print(f'{t2 - t1:.3f} {_build.build_seconds:.3f} {t2 - t0:.3f}')")


def cache_check() -> dict:
    """Seconds of ``_build.load()`` in fresh processes: cold (no cache) and
    warm (the default directory, which this process filled)."""
    out = {}
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for label, extra in (("cold", {"PQVECTOR_TPU_NO_COMPILE_CACHE": "1"}),
                         ("warm", {}), ("warm_again", {})):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _LOAD], env={**env, **extra},
                              capture_output=True, text=True, timeout=600, cwd=ROOT)
        if proc.returncode != 0:
            raise SystemExit(f"cache check {label} failed:\n{proc.stderr}")
        load_s, nvcc_s, import_s = map(float, proc.stdout.split())
        out[label] = {"load_s": load_s, "nvcc_s": nvcc_s, "process_s": import_s,
                      "wall_s": time.perf_counter() - t0}
        print(f"cache {label}: load {load_s:.3f} s (nvcc {nvcc_s:.3f} s), process "
              f"{import_s:.3f} s, wall {out[label]['wall_s']:.3f} s", flush=True)
    return out


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import pqvector_tpu_torch as pqt
    from pqvector_tpu_torch import datasets as ds
    from pqvector_tpu_torch.kernels import _build
    from pqvector_tpu_torch.kernels import assign as ka
    from pqvector_tpu_torch.kernels import stream_topk as st

    cs.check(torch.cuda.is_available(), "no CUDA device")
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds:.2f} s)", flush=True)
    data_dir = os.path.join(ROOT, "data", "torch_slice12_check")
    try:
        path, emb_np, _ = cs.write_rows(ds, data_dir)
        print(f"disk free under {data_dir}: "
              f"{shutil.disk_usage(data_dir).free / 1e9:.1f} GB", flush=True)
        cs.phase2_small_k1_k2(torch, ka, st)
        pqt.IndexBuilder(path, "embedding", device=dev).n_clusters(
            cs.N_CLUSTERS).build_inplace()
        out, k1, k1_f32 = cs.phase12(torch, pqt, _build, ds, ka, path, emb_np, data_dir,
                                     card, device=dev)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    print("slice 12 path: " + json.dumps(out))
    print("K1 bf16 rows: " + json.dumps(k1))
    print("K1 f32 rows: " + json.dumps(k1_f32))
    if "--no-cache-check" not in sys.argv:
        print("kernel cache: " + json.dumps(cache_check()))
    print(card)


if __name__ == "__main__":
    main()
