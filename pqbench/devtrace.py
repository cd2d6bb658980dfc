"""A traced sub-window of a run, reduced to device-busy time and a breakdown.

On a card ``torch.profiler`` records only CUDA activity: the device's
kernels, copies and sets, and the host's CUDA runtime calls. Recording every
host op as well made a search call 60% slower (H100, B = 256), which the
idle share would then report. The window's length is the host clock's from
``start`` to ``stop``; busy time is the union of the device intervals, so
kernels that overlap count once. An idle gap between two device intervals is
named by the runtime call the host was in at its middle ("host" when none:
Python or torch's own host code between calls). On the CPU (the tests) the
profiler records host ops and finds no device time.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
NAME = 160  # characters kept of a kernel's name: its signature cut at the argument list
WALK = 4096  # runtime calls looked back through for the one around a gap


class TraceWindow:
    """``start()`` ... ``stop() -> summary``."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        act = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
        self._prof = profile(activities=[act])
        self.summary: dict | None = None

    def start(self) -> None:
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="pqbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = reduce_events(events, window_s)
        return self.summary


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    name = name.removeprefix("void ")
    depth = 0
    for i, c in enumerate(name):  # the argument list: "(" after a name, outside "<>"
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i and (name[i - 1].isalnum() or name[i - 1] in "_>"):
            name = name[:i]
            break
    return name[:NAME]


def _top(totals: dict) -> list:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce_events(events: list, window_s: float) -> dict:
    """Chrome-trace events of a window of ``window_s`` seconds -> window_s,
    busy_s, kernel count, the device ops that took most time and the idle
    gaps between device work by the host's runtime call (seconds)."""
    by_name = defaultdict(float)
    intervals = []
    kernels = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        intervals.append((a, b))
        by_name[_short(e["name"])] += (b - a) * 1e-6
        kernels += e["cat"] == "kernel"
    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
        for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
    )
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        label = "host"
        for j in range(i, max(i - WALK, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gaps[label] += (b - a) * 1e-6
    inside = sum(gaps.values())
    edges = max(0.0, window_s - busy_s - inside)
    if busy and edges > 0:
        gaps["before the first and after the last device op"] += edges
    return {
        "window_s": window_s,
        "busy_s": min(busy_s, window_s),
        "kernels": kernels,
        "device_ops": _top(by_name),
        "idle_gaps": _top(gaps),
    }
