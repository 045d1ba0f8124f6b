"""Meshes of ranks for multi-device and multi-host execution.

Counterpart of zklaim_tpu/parallel/mesh.py on torch.distributed.  Where the
JAX package sees every device of every host in one process, torch runs one
process a device: a rank.  A Mesh is a grid of ranks with named axes, built
the same way on every rank, and holds a process group for each set of its
axes (every rank builds every group, in one order, as torch.distributed
requires), so a collective over an axis -- or over a tuple of axes,
flattened in the tuple's order -- runs among the ranks that share the other
coordinates.

Backends: NCCL when the ranks hold CUDA devices, gloo on the CPU; a CUDA
tensor never goes over gloo (`Mesh.check` raises).  Once a process group
exists every collective goes through it, a world of one too; a single
process without one has a mesh of one rank whose collectives are the
identity.

`init_distributed()` resolves its arguments as the JAX function does --
the parameter, then ZKLAIM_COORDINATOR / ZKLAIM_NUM_PROCESSES /
ZKLAIM_PROCESS_ID -- and, where neither names a coordinator or a count,
torchrun's env:// variables (MASTER_ADDR and WORLD_SIZE set) take the place
of the JAX package's TPU-pod autodetection (TPU_WORKER_HOSTNAMES).  With
nothing configured it does nothing and returns False, so every entry point
may call it.  A coordinator "host:port" becomes tcp://host:port; an address
with a scheme (file://..., env://) is passed as it is.

`make_host_mesh()` groups the ranks by host name, as the JAX version groups
devices by process.

Devices: a rank's device defaults to a card (cuda:<LOCAL_RANK>, else the
process id modulo the cards) and, as every entry point of the package,
raises where there is none; only an explicit device="cpu" gives a gloo
world on the CPU.
"""

from __future__ import annotations

import itertools
import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device

_DIST_STATE = {"initialized": False}


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    timeout_s: float = 600.0,
) -> bool:
    """Initialize the process group (idempotent).

    device: this rank's device (default: cuda:<LOCAL_RANK or the rank modulo
    the cards>; RuntimeError without CUDA, as default_device()); it picks the
    backend (NCCL for CUDA, gloo for the CPU) and, for CUDA, becomes the
    current device.  Returns False, doing nothing, when nothing is
    configured."""
    if _DIST_STATE["initialized"]:
        return True
    coordinator_address = coordinator_address or os.environ.get("ZKLAIM_COORDINATOR")
    env_np = os.environ.get("ZKLAIM_NUM_PROCESSES")
    env_pid = os.environ.get("ZKLAIM_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None)
    process_id = process_id if process_id is not None else (int(env_pid) if env_pid else None)
    if coordinator_address is None and num_processes is None:
        if os.environ.get("MASTER_ADDR") is None or os.environ.get("WORLD_SIZE") is None:
            return False
        init_method = "env://"          # torchrun: world size and rank from its variables
    elif "://" in (coordinator_address or ""):
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device is None:
        default_device()                        # raises without CUDA
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local else (process_id or 0) % torch.cuda.device_count()
        device = torch.device("cuda", index)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"backend": _backend(device), "init_method": init_method,
              "timeout": timedelta(seconds=timeout_s)}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)
    _DIST_STATE["initialized"] = True
    _DIST_STATE["device"] = device
    return True


def shutdown_distributed() -> None:
    """Destroy the process group init_distributed made (if any), so that a
    later init_distributed starts anew."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _DIST_STATE.clear()
    _DIST_STATE["initialized"] = False


def world() -> tuple[int, int]:
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device() -> torch.device:
    """This rank's device: the one init_distributed chose, else the first
    card (RuntimeError without CUDA, as default_device())."""
    if "device" in _DIST_STATE:
        return _DIST_STATE["device"]
    return default_device()


class Mesh:
    """A grid of ranks with named axes, this rank's place in it, and a
    process group for each set of axes."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple, device=None):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"a {ranks.ndim}-D grid of ranks with axes {axis_names}")
        self.devices = ranks                    # the JAX Mesh's name for the grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.size = ranks.size
        self.device = torch.device(device) if device is not None else rank_device()
        self.rank, size = world()
        self.distributed = dist.is_available() and dist.is_initialized()
        if ranks.min() < 0 or ranks.max() >= size or len(set(ranks.flat)) != ranks.size:
            raise ValueError(f"ranks {ranks.tolist()} are not distinct ranks of a world of {size}")
        where = np.argwhere(ranks == self.rank)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups = {}
        if self.distributed:
            # every rank creates every group of every set of axes, in one order
            for r in range(1, len(self.axis_names) + 1):
                for axes in itertools.combinations(range(len(self.axis_names)), r):
                    self._make_groups(axes)

    def _make_groups(self, axes: tuple) -> None:
        others = [i for i in range(self.devices.ndim) if i not in axes]
        grid = np.transpose(self.devices, others + list(axes))
        grid = grid.reshape(-1, int(np.prod([self.devices.shape[i] for i in axes])))
        for members in grid:
            ranks = sorted(int(r) for r in members)
            group = (dist.group.WORLD if len(ranks) == dist.get_world_size()
                     else dist.new_group(ranks))
            if self.rank in ranks:
                self._groups[axes] = group

    def _axes(self, axis) -> tuple:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return tuple(self.axis_names.index(a) for a in names)

    def axis_size(self, axis) -> int:
        """The shard count of `axis` (a name or a tuple of names)."""
        return int(np.prod([self.devices.shape[i] for i in self._axes(axis)]))

    def _members(self, axis) -> np.ndarray:
        """The ranks along `axis` that share this rank's other coordinates,
        by shard index (the tuple's axes flattened, the first one major)."""
        axes = self._axes(axis)
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in this mesh")
        index = tuple(slice(None) if i in axes else self.coords[i]
                      for i in range(self.devices.ndim))
        sub = self.devices[index]                                  # the axes in mesh order
        return np.transpose(sub, [sorted(axes).index(a) for a in axes]).reshape(-1)

    def shard_index(self, axis) -> int:
        """This rank's shard along `axis`."""
        return int(np.flatnonzero(self._members(axis) == self.rank)[0])

    def check(self, t: torch.Tensor) -> None:
        """A collective's tensor lies on the mesh's device, and a CUDA tensor
        never goes over gloo."""
        if t.device.type != self.device.type:
            raise ValueError(f"a tensor on {t.device} for a mesh on {self.device}")
        if self.distributed and dist.get_backend() != _backend(t.device):
            raise ValueError(f"a tensor on {t.device} over a {dist.get_backend()} process group")

    def all_gather(self, t: torch.Tensor, axis) -> torch.Tensor:
        """(S, *t.shape): every shard's t along `axis`, by shard index."""
        self.check(t)
        members = self._members(axis)
        if not self.distributed:
            return t[None].clone()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in members]
        dist.all_gather(parts, t, group=self._groups[tuple(sorted(self._axes(axis)))])
        by_rank = dict(zip(sorted(int(r) for r in members), parts))
        return torch.stack([by_rank[int(r)] for r in members])

    def all_to_all(self, t: torch.Tensor, axis) -> torch.Tensor:
        """t: (S, ...) chunks, chunk i for shard i -> (S, ...), chunk i from
        shard i (torch's all_to_all_single on dim 0, in shard order)."""
        self.check(t)
        members = self._members(axis)
        if not self.distributed:
            return t.clone()
        if t.shape[0] != len(members):
            raise ValueError(f"all_to_all: {t.shape[0]} chunks for {len(members)} shards")
        ranks = sorted(int(r) for r in members)
        if list(members) != ranks:              # the group's order is the ranks' order
            to_group = [int(np.flatnonzero(members == r)[0]) for r in ranks]
            t = t[to_group]
        out = torch.empty_like(t.contiguous())
        dist.all_to_all_single(out, t.contiguous(),
                               group=self._groups[tuple(sorted(self._axes(axis)))])
        if list(members) != ranks:
            out = out[[ranks.index(int(r)) for r in members]]
        return out


def make_mesh(n: int | None = None, axis: str = "shards", device=None) -> Mesh:
    """1-D mesh over the first n ranks (default: all of them)."""
    _, size = world()
    n = n or size
    if n > size:
        raise ValueError(f"requested {n} ranks, have {size}")
    return Mesh(np.arange(n), (axis,), device)


def _rank_hosts() -> list:
    """Every rank's host name, by rank."""
    mine = socket.gethostname()
    _, size = world()
    if size == 1:
        return [mine]
    hosts = [None] * size
    dist.all_gather_object(hosts, mine)
    return hosts


def host_grid(hosts: list) -> np.ndarray:
    """(num_hosts, ranks_per_host) grid of ranks from every rank's host: a
    row a host, in the order of each host's first rank, ranks ascending.
    Raises ValueError on uneven hosts."""
    by_host: dict = {}
    for rank, host in enumerate(hosts):
        by_host.setdefault(host, []).append(rank)
    counts = {len(v) for v in by_host.values()}
    if len(counts) != 1:
        raise ValueError(f"uneven ranks per host: { {k: len(v) for k, v in by_host.items()} }")
    return np.array(list(by_host.values()), dtype=np.int64)


def make_host_mesh(axes: tuple[str, str] = ("host", "chip"), device=None) -> Mesh:
    """2-D (num_hosts, ranks_per_host) mesh: the trailing axis stays within
    a host, collectives over `axes[0]` cross hosts.  A single process gives
    a (1, 1) mesh, a world on one host (1, n)."""
    return Mesh(host_grid(_rank_hosts()), axes, device)


def flat_shard_axis(mesh: Mesh) -> tuple[str, ...]:
    """The axis names to shard a 1-D data dimension over `mesh` --
    ('host', 'chip') for host meshes, ('shards',) for flat ones -- the
    first one major."""
    return tuple(mesh.axis_names)
