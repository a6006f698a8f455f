"""The process world of the sharded steps, on `torch.distributed`.

Counterpart of `pim_tpu.parallel.dist`.  Every process runs the same
program; one rank per process, each driving one device.  The scene is
replicated on every rank's device and the pixel or texel axis is split into
contiguous rank-major slices.

Environment contract (the JAX package's):
  PIM_COORDINATOR   "host:port" of rank 0   (default 127.0.0.1:7621)
  PIM_NUM_PROCS     world size              (default 1 -> no-op)
  PIM_PROC_ID       this process's rank
  PIM_DIST_INIT_S   seconds the world may take to form (default 600)

The world forms over gloo on `tcp://<coordinator>`.  Its collectives run
on NCCL when each rank has a card of its own: the ranks then gather their
(host, card) pairs, and when no two are equal an NCCL group over the whole
world carries the steps' all-reduces.  Ranks on the CPU, or sharing a card
(NCCL refuses two ranks on one device), reduce over the gloo world.  The
choice is logged.  A world that fails to form raises; it never falls back
to a world of one.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from pim_tpu_torch.core.console import LogSev, con_logf

DEFAULT_COORDINATOR = "127.0.0.1:7621"

# set by init_distributed: the group that carries the steps' collectives
# when it is not the default group (an NCCL group over a gloo world), and
# this rank's device
_collective_group = None
_device: Optional[torch.device] = None


class DistInfo(NamedTuple):
    process_id: int
    num_processes: int
    coordinator: str

    @property
    def is_main(self) -> bool:
        return self.process_id == 0


def default_device(process_id: int = 0) -> torch.device:
    """The card of a rank, cards taken round-robin by rank (a rank asks for
    the CPU by passing its device)."""
    return torch.device("cuda", process_id % max(1, torch.cuda.device_count()))


def _card_key(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else device.index}"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> DistInfo:
    """Join the process world.  One process (num_processes <= 1) is a
    no-op, and so is a second call, so every entry point can call this
    unconditionally.

    device: this rank's device (default: `default_device(process_id)`);
    it decides the backend of the collectives."""
    global _collective_group, _device
    coordinator = coordinator or os.environ.get("PIM_COORDINATOR", DEFAULT_COORDINATOR)
    if num_processes is None:
        num_processes = int(os.environ.get("PIM_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PIM_PROC_ID", "0"))
    if num_processes <= 1:
        return DistInfo(0, 1, coordinator)
    if dist.is_initialized():  # joined already (an entry point calls this again)
        return DistInfo(dist.get_rank(), dist.get_world_size(), coordinator)

    device = default_device(process_id) if device is None else torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=int(os.environ.get("PIM_DIST_INIT_S", "600")))
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, timeout=timeout)
    backend = "gloo"
    _collective_group, _device = None, device
    if device.type == "cuda":
        keys = [None] * num_processes
        dist.all_gather_object(keys, _card_key(device))
        if len(set(keys)) == num_processes:
            _collective_group = dist.new_group(backend="nccl", timeout=timeout)
            backend = "nccl"
    why = {"nccl": "a card a rank", "gloo": "the ranks share a card" if device.type == "cuda"
           else "CPU ranks"}[backend]
    con_logf(LogSev.Info, "dist", "rank %d of %d joined tcp://%s on %s; collectives on %s (%s)",
             process_id, num_processes, coordinator, device, backend, why)
    return DistInfo(process_id, num_processes, coordinator)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 'dp' axis: the process group of the collectives (None for a
    world of one), this rank, the world size and this rank's device."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return "none" if self.group is None else dist.get_backend(self.group)


def global_mesh(device=None) -> Mesh:
    """The mesh of the current world (a world of one when no process group
    is initialised).  device: this rank's device (default:
    the device given to `init_distributed`, else `default_device(rank)`)."""
    if not dist.is_initialized():
        return Mesh(None, 0, 1, default_device(0) if device is None else torch.device(device))
    rank = dist.get_rank()
    if device is None:
        device = _device if _device is not None else default_device(rank)
    group = _collective_group if _collective_group is not None else dist.group.WORLD
    return Mesh(group, rank, dist.get_world_size(), torch.device(device))


def local_pixels(mesh: Mesh, n: int):
    """(this rank's contiguous rank-major rows of the n pixels, their ids
    on the mesh's device)."""
    assert n % mesh.size == 0, f"pixels {n} must divide devices {mesh.size}"
    per = n // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return rows, torch.arange(rows.start, rows.stop, dtype=torch.int64, device=mesh.device)


def replicate(tree, mesh: Mesh):
    """`tree` (tensors in tuples, lists, dicts, NamedTuples and
    dataclasses, such as a built scene) with every tensor on the mesh's
    device: the replicated scene tables."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: replicate(getattr(tree, f.name), mesh)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(x, mesh) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(x, mesh) for x in tree)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return tree


def _world() -> tuple:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_local_slice(n: int) -> slice:
    """This process's contiguous row range of a rank-major split leading
    axis of global length n."""
    pid, pc = _world()
    assert n % pc == 0, f"global size {n} must divide process count {pc}"
    per = n // pc
    return slice(pid * per, (pid + 1) * per)


def allgather_rows(local_rows: np.ndarray) -> np.ndarray:
    """Host-side gather of every rank's rows (equal shapes), rank-major:
    the screenshot/checkpoint readback path."""
    _, pc = _world()
    if pc == 1:
        return local_rows
    rows = torch.from_numpy(np.ascontiguousarray(local_rows))
    if dist.get_backend() == "nccl":
        rows = rows.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(rows) for _ in range(pc)]
    dist.all_gather(parts, rows)
    return torch.cat(parts).cpu().numpy().reshape((-1,) + local_rows.shape[1:])
