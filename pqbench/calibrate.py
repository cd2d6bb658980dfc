"""Readings for the limits of ``correct``: the program's numbers and the
control's on the same seeded inputs, at the cell's own size.

    python3 pqbench/calibrate.py --workload <cell> --seeds 11,12,13 [--control 1] [--calls N]
        [--fault no_lloyd]

For a search cell each seed sets up as a run does, sends the first ``N``
pool batches through the program's searcher (untimed) and judges them, then
puts the control (``reference/control.py``) in the searcher's place for the
same batches. For the build cell it builds the seeded file in place once
and judges the payload, then judges the control's build of the same rows.
``--fault no_lloyd`` plants a fault in the program first: its k-means keeps
the k-means++ seeds and runs no Lloyd iteration. One JSON line a seed and
side. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def search_readings(run, driver, calls: int, control: bool) -> list[dict]:
    import torch

    from pqbench.reference.control import ControlSearcher
    from pqbench.reference.exact import Layout

    st = driver.setup(run)
    b = run.traffic["batch"]
    kept = {}
    for i in range(calls):
        q = st["pool"][i * b : (i + 1) * b]
        d, ids = st["searcher"].search(q, run.traffic["k"], run.traffic["nprobe"],
                                       mode=run.traffic["mode"])
        kept[i] = (d.cpu(), ids.cpu())
    st["searcher"] = None
    out = [("program", kept)]
    if control:
        dev = run.device
        layout = Layout(torch.from_numpy(st["rows"]).to(dev),
                        torch.from_numpy(st["assign"]).to(dev),
                        torch.from_numpy(st["cents"]).to(dev))
        ctrl = ControlSearcher(layout)
        kept_c = {}
        for i in range(calls):
            q = st["pool"][i * b : (i + 1) * b].to(dev)
            d, ids = ctrl.search(q, run.traffic["k"], run.traffic["nprobe"])
            kept_c[i] = (d.cpu(), ids.cpu())
        del layout, ctrl
        out.append(("control", kept_c))
    lines = []
    for side, k in out:
        numbers, info, recall = driver.judge(run, st, k)
        lines.append({"side": side, "numbers": numbers, "info": info, "recall": recall})
    return lines


def build_readings(run, driver, control: bool) -> list[dict]:
    import torch

    from pqbench.reference.compare import build_numbers
    from pqbench.reference.control import control_build

    tmp = tempfile.mkdtemp(prefix="pqbench-")
    try:
        path = os.path.join(tmp, "rows.parquet")
        rows_host, size0 = driver.write_file(run, path)
        driver.builder_for(run, path).build_inplace()
        sizes = [size0, os.path.getsize(path)]
        numbers, info = driver.read_back(run, path, rows_host, sizes)
        lines = [{"side": "program", "numbers": numbers, "info": info}]
        if control:
            rows = torch.from_numpy(rows_host).to(run.device)
            p = control_build(rows, run.config["n_clusters"], run.config["kmeans_iters"],
                              run.config["kmeans_seed"])
            faults, excess, km = build_numbers(rows, p, driver.reference_objective(run, rows))
            lines.append({"side": "control", "numbers": {
                "payload_faults": float(faults), "assign_excess": excess, "kmeans_excess": km}})
        return lines
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def no_lloyd(program) -> None:
    """Plant a fault: the program's k-means returns its k-means++ seeds."""
    import importlib

    import torch

    mod = importlib.import_module(program.__name__ + ".index.kmeans")

    def seeds_only(x, centroids0, max_iters, block, n_clusters):
        del max_iters, block, n_clusters
        return centroids0.clone(), torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)

    mod._lloyd = seeds_only


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--calls", type=int, default=0, help="search batches a seed "
                    "(0: the traffic's recall_calls + 64)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=("none", "no_lloyd"), default="none")
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "pqbench":
        sys.path[0] = str(ROOT)
    import torch

    import pqvector_tpu_torch as program
    from pqbench.harness import Bench, Run

    if args.fault == "no_lloyd":
        no_lloyd(program)
    bench = Bench(ROOT)
    entry = bench.cell(args.workload)
    traffic = bench.traffic(entry["traffic"])
    driver = bench.driver(traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = Run(args.workload, bench.config(entry["config"]), traffic, seed, 0.0, False,
                  torch.device(args.device), program, time.perf_counter(), log)
        if traffic["driver"] == "build_loop":
            lines = build_readings(run, driver, bool(args.control))
        else:
            calls = args.calls or traffic["recall_calls"] + 64
            lines = search_readings(run, driver, calls, bool(args.control))
        for line in lines:
            line.update(seed=seed, cell=args.workload, fault=args.fault,
                        seconds=time.perf_counter() - t)
            print(json.dumps(line), flush=True)
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
