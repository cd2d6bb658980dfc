"""Run one cell of ``BENCHMARK.json`` once on the card and print one JSON line.

    python3 pqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero and prints no result when there is no CUDA card (or fewer
than the cell asks for), when the program is not inside this checkout, or
when JAX or the JAX package got loaded. The last lines on standard error are
the numbers compared, each beside its limit; the result's last key,
``checks``, holds them too.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Run as a script, the interpreter put pqbench/ itself first on the path.
    if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "pqbench":
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from pqbench.harness import Bench, forbidden_loaded, run_cell

    bench = Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    os.environ.pop("PQVECTOR_TPU_NO_COMPILE_CACHE", None)  # kernels cached in the checkout
    try:
        import pqvector_tpu_torch as program
    except ImportError as exc:
        log(f"the program is not in this checkout: {exc}")
        return 2
    if ROOT not in Path(program.__file__).resolve().parents:
        log(f"the program was loaded from {program.__file__}, outside {ROOT}")
        return 2

    result, rows = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda"), program, T0, log)
    found = forbidden_loaded()
    if found:
        log("forbidden modules loaded: " + ", ".join(found))
        return 3
    for name, value, limit in rows:
        log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
