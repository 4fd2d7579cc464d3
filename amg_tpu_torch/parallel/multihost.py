"""Multi-process operation on ``torch.distributed``.

The port of ``amg_tpu/parallel/multihost.py``.  Every process runs the same
program; :func:`initialize` joins them into one process group (gloo for
CPU tensors, NCCL between cards).  A mesh (:func:`~amg_tpu_torch.
parallel.dist.make_mesh`) then gives each process a contiguous run of the
ring's shards on its own device: a process owns one contiguous block of
rows, so the ring's halo exchanges cross a process boundary once per pair
of neighbouring processes, and the shards inside one process exchange
nothing (their windows are views of one haloed vector).

Two ways to start the processes:

* torchrun (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
  ``LOCAL_RANK``): ``initialize()`` reads them;
* ``amg_tpu``'s variables ``AMG_COORDINATOR`` (``host:port``),
  ``AMG_NUM_PROCESSES`` and ``AMG_PROCESS_ID``, or the same as arguments.

NCCL refuses two ranks of one communicator on one card, so on a machine
with one card a multi-process run uses the CPU (gloo); one NCCL rank with
all its shards on the card is the single-card form of the same code.

The group's backend sets the route of the solvers' steps
(:class:`~amg_tpu_torch.solve.loop_graph.StepGraphs`): in an NCCL group
each step of a host loop is a CUDA graph, captured once with its
``all_reduce``, all-gathers and halo messages and replayed, as on a mesh
held by one process; a gloo group on the CPU runs the steps on static
buffers, and one on the card (gloo on CUDA tensors) runs them eagerly.
``krylov.cg``, ``gmres`` and ``fcg`` with an NCCL group's ``psum`` run as
one CUDA graph each, the group's collectives inside its while bodies
(``krylov._route``); with a gloo group's, as host loops.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..hierarchy import resolve_device


def local_rank(rank: int | None = None) -> int:
    """This process's index on its host: ``LOCAL_RANK`` (torchrun), else
    the global rank (``rank``, or the process group's) modulo the host's
    cards (one process per card)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(n, 1)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device="cuda", timeout_s: float = 600.0) -> bool:
    """Join this process to a multi-process run.

    Arguments, else ``AMG_COORDINATOR`` / ``AMG_NUM_PROCESSES`` /
    ``AMG_PROCESS_ID``, else torchrun's ``MASTER_ADDR`` / ``WORLD_SIZE`` /
    ``RANK``.  The backend follows ``device``: NCCL for ``cuda`` (the
    default; raises without a card), gloo for ``cpu``.  Returns True when
    a process group is (or already was) initialized, False when nothing
    asks for one.  Idempotent.
    """
    if dist.is_initialized():
        return True
    device = resolve_device(device)
    coordinator_address = coordinator_address or os.environ.get(
        "AMG_COORDINATOR")
    if num_processes is None and "AMG_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["AMG_NUM_PROCESSES"])
    if process_id is None and "AMG_PROCESS_ID" in os.environ:
        process_id = int(os.environ["AMG_PROCESS_ID"])
    if coordinator_address is not None or num_processes is not None:
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        init = dict(init_method="env://")
    else:
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        # before the group exists: the rank this process is joining as
        torch.cuda.set_device(local_rank(
            process_id if process_id is not None
            else int(os.environ.get("RANK", 0))))
    dist.init_process_group(backend, timeout=datetime.timedelta(
        seconds=timeout_s), **init)
    return True


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def fetch(x, mesh=None) -> np.ndarray:
    """A row-sharded ``(S, m)`` tensor, or a replicated one, as one host
    numpy vector, the same on every process: this process's shards when
    it holds them all, else every process's shards gathered over
    ``mesh``'s group (``amg_tpu``'s ``process_allgather``)."""
    if mesh is None or mesh.world == 1 or x.dim() < 2:
        return x.reshape(-1).cpu().numpy()
    return mesh.all_gather(x).reshape(-1).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The ring's shards as a 2-D ``(process, shard)`` grid: ``ids[p, j]``
    is shard ``j`` of process ``p`` (ring order runs along the rows), with
    the axis names of ``amg_tpu``'s ``make_host_mesh``.  ``shape`` maps
    each axis to its size, as a ``jax.sharding.Mesh``'s does."""

    ids: np.ndarray
    axis_names: tuple = ("host", "chip")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ids.shape))


def make_host_mesh(mesh=None, axes: tuple[str, str] = ("host", "chip")):
    """The ``(processes, shards per process)`` view of a ring (default
    :func:`~amg_tpu_torch.parallel.dist.make_mesh`'s: one shard per
    process): ``amg_tpu``'s 2-D ``(process_count, devices per process)``
    mesh (``multihost.py:105-118``), which tells shardings that cross
    processes from those within one.  ``torch.distributed.device_mesh``
    is not used: it assumes one rank per device, and a process here holds
    ``S`` shards of the ring on its one device."""
    from .dist import make_mesh

    mesh = make_mesh(device="cpu") if mesh is None else mesh
    ids = np.arange(mesh.n_shards).reshape(mesh.world, mesh.local)
    return HostMesh(ids, tuple(axes))
