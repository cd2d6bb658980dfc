"""Readings for the limits of ``correct`` in an SQL cell (``pqbench/drivers/
sql_loop.py``): the program's numbers, the control's and those of planted
faults, on the same seeded file and queries, at the cell's own size.

    python3 scripts/sql_calibrate.py --workload sift1m.sql.resident --seeds 11,12,13
        [--calls 512] [--control 1] [--faults fail_predicate,drop_kth,no_rescore]

For each seed it sets up as a run does (the file, ``build_inplace``, the
session and its resident searcher), sends the first ``--calls`` query texts
of the pool through ``session.sql(text).collect()`` untimed, and judges them
with ``reference/sql.py``. ``--control 1`` then answers the same queries
with the reference one precision step down (``reference/control.py``: TF32
probe and re-score, fp8 selection) over the same filtered rows. Each fault
is planted in the program for the same calls, then taken out:

* ``fail_predicate``: ``FilterExec`` passes every row, so a filtered query
  returns rows that fail its predicate;
* ``drop_kth``: the query's table loses its last row (``DataFrame.collect``);
* ``no_rescore``: the resident search keeps its bf16 selection without the
  f32 re-score (``query/device.py:_refine``).

One JSON line a seed and side. Needs the repo root as the working
directory; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FAULTS = ("fail_predicate", "drop_kth", "no_rescore")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def plant(program, fault: str, setattr_) -> None:
    """Plant ``fault`` in ``program`` through ``setattr_(obj, name, value)``
    (``monkeypatch.setattr`` in the tests, an undoing setter here)."""
    physical = importlib.import_module(program.__name__ + ".engine.physical")
    session = importlib.import_module(program.__name__ + ".engine.session")
    device = importlib.import_module(program.__name__ + ".query.device")
    if fault == "fail_predicate":
        setattr_(physical.FilterExec, "execute", lambda self, ctx: self.input.execute(ctx))
    elif fault == "drop_kth":
        real = session.DataFrame.collect

        def drop(self):
            out = real(self)
            return out.slice(0, max(out.num_rows - 1, 0))

        setattr_(session.DataFrame, "collect", drop)
    elif fault == "no_rescore":
        def bf16_order(q, emb, best_d, best_i, out_k=None):
            del q, emb
            return device.select_lex(best_d, best_i, out_k or best_d.shape[1])

        setattr_(device, "_refine", bf16_order)
    else:
        raise ValueError(f"no fault {fault!r}")


@contextlib.contextmanager
def planted(program, fault: str):
    undo = []

    def setattr_(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    plant(program, fault, setattr_)
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def program_answers(st, calls: int) -> list:
    out = []
    for text in st["texts"][:calls]:
        table = st["session"].sql(text).collect()
        out.append((table.column("id").to_numpy(), table.column("dist").to_numpy()))
    return out


def control_answers(ref, q, filtered, k: int, nprobe: int) -> list:
    """The control's answer to each query over the rows that pass its
    predicate."""
    import numpy as np

    from pqbench.reference.control import ControlSearcher

    out = [None] * q.shape[0]
    for side in (False, True):
        which = np.flatnonzero(filtered == side)
        if not which.size:
            continue
        layout, _, to_id = ref._side(side)
        d, ids = ControlSearcher(layout).search(q[which], k, nprobe)
        if to_id is not None:
            ids = ids.where(ids < 0, to_id[ids.clamp_min(0)])
        for j, i in enumerate(which):
            keep = ids[j] >= 0
            out[i] = (ids[j][keep].cpu().numpy(), d[j][keep].double().cpu().numpy())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="sift1m.sql.resident")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=512)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT), help="the benchmark's root")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import pqvector_tpu_torch as program
    from pqbench.harness import Bench, Run

    bench = Bench(Path(args.root))
    entry = bench.cell(args.workload)
    traffic = bench.traffic(entry["traffic"])
    driver = bench.driver(traffic["driver"])
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = Run(args.workload, bench.config(entry["config"]), traffic, seed, 0.0, False,
                  torch.device(args.device), program, time.perf_counter(), log)
        tmp = tempfile.mkdtemp(prefix="pqbench-sql-")
        try:
            path = os.path.join(tmp, "t.parquet")
            st = driver.setup(run, path)
            calls = min(args.calls, len(st["texts"]))
            sides = [("program", program_answers(st, calls))]
            for fault in faults:
                with planted(program, fault):
                    sides.append((f"fault:{fault}", program_answers(st, calls)))
            st["session"] = st["searcher"] = None
            ref = driver.reference_for(run, path)
            q = st["pool"][:calls].to(run.device)
            filtered = st["filtered"][:calls]
            k, nprobe = traffic["k"], run.config["nprobe"]
            if args.control:
                sides.append(("control", control_answers(ref, q, filtered, k, nprobe)))
            for side, got in sides:
                numbers, info, recall = ref.judge(q, filtered, got, k, nprobe)
                print(json.dumps({"side": side, "numbers": numbers, "info": info,
                                  "recall": recall, "seed": seed, "cell": args.workload,
                                  "seconds": time.perf_counter() - t}), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
