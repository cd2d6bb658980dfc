"""A device mesh in one process, and its two collectives.

Counterpart of ``pqvector_tpu/dist/mesh.py``. The JAX package is
single-controller: one process holds a ``Mesh`` of devices and ``shard_map``
runs one body per device. Here one process holds a ``Mesh``, a tuple of
torch devices with one entry per shard, and runs each shard's work in turn
under that shard's device (``device_scope``); the work is asynchronous on a
card, so the shards' launches queue before any result is read. The
collectives are plain functions: ``all_gather`` stacks the shards' tensors
on the mesh's first device in shard order, and ``psum`` adds the shards'
terms there in shard order and hands the total back to every shard's
device. The fixed order makes a sharded run reproducible bit for bit. Multi-process serving
(``torch.distributed``) has no counterpart in the JAX package and is not
here.

A mesh may name one device several times: ``make_mesh(4, device="cuda:0")``
puts four shards on one card, ``make_mesh(8, device="cpu")`` eight on the
CPU. That is a request the caller makes; ``device=None`` takes distinct
CUDA devices and never falls back to the CPU or to repeating a card.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .._device import resolve_device

DATA_AXIS = "data"
CLUSTER_AXIS = "cluster"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard devices in row-major order over ``shape``: for the 2-D
    ``(data, cluster)`` mesh, shard ``r * C + g`` is data row ``r`` of
    cluster group ``g`` (the JAX package's ``P((data, cluster))`` order)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _named(device) -> torch.device:
    """A device with its index: ``cuda`` becomes the current card, so that
    a tensor's ``.device`` compares equal to its shard's."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(None)  # RuntimeError without a card
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_devices(need: int, device, what: str) -> tuple[torch.device, ...]:
    if need < 1:
        raise ValueError(f"a mesh needs at least one shard, got {need}")
    if device is not None:
        return (_named(device),) * need
    resolve_device(None)  # RuntimeError without a card
    count = torch.cuda.device_count()
    if need > count:
        raise ValueError(f"Requested {what} but only {count} devices available")
    return tuple(torch.device("cuda", i) for i in range(need))


def device_count() -> int:
    """CUDA devices present; ``RuntimeError`` where there is no card."""
    resolve_device(None)
    return torch.cuda.device_count()


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS,
              device: str | torch.device | None = None) -> Mesh:
    """1-D mesh. ``device=None``: the first ``n_devices`` CUDA devices (all
    by default), ``ValueError`` where fewer are present. ``device`` given:
    ``n_devices`` shards (default 1) on that one device."""
    if n_devices is None:
        n_devices = 1 if device is not None else device_count()
    devices = _mesh_devices(n_devices, device, f"{n_devices} devices")
    return Mesh(devices, (axis,), (n_devices,))


def make_mesh_2d(data: int, cluster: int,
                 device: str | torch.device | None = None) -> Mesh:
    """2-D ``(data, cluster)`` mesh for probe fan-out: clusters are
    partitioned across the cluster axis and each cluster group's rows are
    sharded across the data axis. Devices as ``make_mesh``."""
    devices = _mesh_devices(data * cluster, device, f"{data}x{cluster} mesh")
    return Mesh(devices, (DATA_AXIS, CLUSTER_AXIS), (data, cluster))


def device_scope(device: torch.device):
    """The context a shard's work runs in: its card is the current CUDA
    device, so that a kernel launches there, on that card's current stream
    (the wrappers launch on the current device and stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.require(x, requirements=["C", "W"]))


def shard_rows(x, mesh: Mesh) -> list[torch.Tensor]:
    """``x`` [n, ...] (numpy or tensor) split into ``mesh.size`` equal row
    blocks, block ``s`` on shard ``s``'s device (a view where that is
    ``x``'s own device); ``n`` must divide."""
    t = _as_tensor(x)
    if t.shape[0] % mesh.size:
        raise ValueError(f"{t.shape[0]} rows do not split into {mesh.size} shards")
    per = t.shape[0] // mesh.size
    return [t[s * per : (s + 1) * per].to(dev) for s, dev in enumerate(mesh.devices)]


def replicate(x, mesh: Mesh) -> list[torch.Tensor]:
    """One copy of ``x`` per shard, on its device; shards on one device
    share a copy."""
    t = _as_tensor(x)
    copies: dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = t.to(dev, non_blocking=True)
    return [copies[dev] for dev in mesh.devices]


def all_gather(parts: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """[n_shards, ...] on the mesh's first device, in shard order; a shard
    on another card is a peer copy that does not block the host."""
    dst = mesh.devices[0]
    return torch.stack([p.to(dst, non_blocking=True) for p in parts])


def psum(parts: list[list[torch.Tensor]], mesh: Mesh) -> list[torch.Tensor]:
    """The sum of every shard's terms (``parts[s]``, a shard's partial
    results in the order it made them), added one after another from zero
    on the first device, in shard order and then term order; the total is
    handed back to every shard's device. Where the shards' terms are the
    blocks of one row order, the total has the bits of a one-device loop
    over those blocks."""
    dst = mesh.devices[0]
    terms = [t.to(dst, non_blocking=True) for part in parts for t in part]
    total = torch.zeros_like(terms[0])
    for t in terms:
        total = total + t
    return replicate(total, mesh)
