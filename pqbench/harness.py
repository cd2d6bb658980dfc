"""Finding a cell's files by name, and running one cell once.

``BENCHMARK.json`` maps a cell to a configuration (``configs`` entry and
its file) and a traffic mix (``traffic/<name>.json``, which names its driver
``drivers/<driver>.py``); ``limits/<cell>.json`` holds the limits of the
numbers compared; ``metrics/<name>.py`` reads one per-layer metric from the
traced run's record. A later cell, mix, driver or metric is a new file and a
new entry: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable

from .reference.compare import judge

#: Top-level module names that may not be loaded in a run: JAX and the JAX
#: package. Compared whole, so ``pqvector_tpu_torch`` is not among them.
FORBIDDEN = ("jax", "jaxlib", "flax", "pqvector_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()


def device_kind(device) -> str:
    if device.type != "cuda":
        return device.type
    import torch

    return torch.cuda.get_device_name(device)


def _load_module(path: Path, prefix: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {prefix} file {path}")
    name = f"pqbench_{prefix}_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "pqbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _named(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        with open(self.root / self._named("configs", name)["file"]) as f:
            return json.load(f)

    def _json(self, sub: str, name: str) -> dict:
        with open(self.dir / sub / f"{name}.json") as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def driver(self, name: str):
        return _load_module(self.dir / "drivers" / f"{name}.py", "driver")

    def reader(self, metric: str) -> Callable[[dict], float | None]:
        return _load_module(self.dir / "metrics" / f"{metric}.py", "metric").read

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer ones."""
        entries = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell's files, the run's arguments, the program."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    program: Any  # the pqvector_tpu_torch module
    t0: float  # the process's start on the host clock (time.perf_counter)
    log: Callable[[str], None]


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool,
             device, program, t0: float, log) -> tuple[dict, list]:
    """Run ``cell`` once -> (the result object, [(name, value, limit)])."""
    entry = bench.cell(cell)
    traffic = bench.traffic(entry["traffic"])
    run = Run(cell, bench.config(entry["config"]), traffic, int(seed), float(seconds),
              bool(trace), device, program, t0, log)
    record = bench.driver(traffic["driver"]).run(run)
    metrics = {}
    for m in bench.metrics(cell, trace):
        value = bench.reader(m["name"])(record) if trace else record["e2e"].get(m["name"])
        if value is None:
            if trace:
                continue  # nothing to read in this run: the metric is left out
            raise RuntimeError(f"the driver gave no {m['name']}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, rows = judge(record["numbers"], bench.limits(cell))
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": record["device_kind"],
        "count": 1,
        "memory_peak_bytes": record["memory_peak_bytes"],
    }
    result = {
        "correct": bool(ok and record["failed"] == 0 and all(
            math.isfinite(v["value"]) for v in metrics.values())),
        "attempted": record["attempted"],
        "failed": record["failed"],
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        summary = record["trace"]
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": _finite(value), "limit": limit}
                        for name, value, limit in rows}
    for m in metrics.values():
        m["value"] = _finite(m["value"])
    return result, rows


def _finite(value: float) -> float:
    """JSON has no infinity: a reading of +-inf or NaN prints as the largest
    float (it fails every limit; ``correct`` is already false)."""
    return value if math.isfinite(value) else sys.float_info.max
