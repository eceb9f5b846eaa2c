"""Process-group set-up and the cross-rank helpers of the mains.

Counterpart of ``ladi_vton_tpu/core/distributed.py``.  The JAX package
runs one process per host over a device mesh; the port runs one process
per rank, as ``python -m torch.distributed.run`` (torchrun) starts them,
and the mesh becomes process groups (``core.mesh``).

* ``initialize`` joins the default process group from the launcher's
  environment: torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
  ``RANK``/``LOCAL_RANK``, or the JAX package's ``COORDINATOR_ADDRESS``
  (``host:port``)/``NUM_PROCESSES``/``PROCESS_ID``.  Without either it is
  a no-op: one process, as in JAX.
* The device and backend rule (``local_device``, ``check_backend``): a
  rank's device is ``cuda:{LOCAL_RANK}``.  More local ranks than cards
  runs only over gloo, where the ranks share the cards in turn (one
  printed line says so); NCCL with more ranks than cards raises before
  any work; ``cpu`` uses gloo.
* Every group gets a finite ``timeout``, so a rank that dies ends the
  others' collectives with an error instead of a hang.
* ``gather_to_host`` is ``multihost_utils.process_allgather``: every
  rank's array, stacked in rank order, on every rank; it goes through
  host memory over gloo, which has no CUDA ``all_gather``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)
BACKENDS = ("gloo", "nccl")

# a gloo group over every rank for host-memory collectives, where the
# default group is NCCL (the default group itself where it is gloo)
_host_group = None


def _env(*names: str) -> Optional[str]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return value
    return None


def coordinator_from_env() -> Optional[str]:
    """``host:port`` of rank 0's store from the launcher's environment."""
    addr = _env("COORDINATOR_ADDRESS")
    if addr is not None:
        return addr
    host, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
    if host is not None and port is not None:
        return f"{host}:{port}"
    return None


def local_rank() -> int:
    """This process's index among the ranks of its host."""
    value = _env("LOCAL_RANK")
    if value is not None:
        return int(value)
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size(world: Optional[int] = None) -> int:
    """The ranks on this host: the launcher's ``LOCAL_WORLD_SIZE``, else
    every rank (``world``, or the process group's size)."""
    value = _env("LOCAL_WORLD_SIZE")
    if value is not None:
        return int(value)
    if world is not None:
        return world
    return dist.get_world_size() if dist.is_initialized() else 1


def default_backend(device) -> str:
    """NCCL for CUDA ranks, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, local_ranks: int) -> None:
    """Refuse a backend the device cannot take, before any work: NCCL on
    the CPU, or NCCL with more local ranks than cards (NCCL refuses two
    ranks on one device)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown distributed backend {backend!r} "
                         f"(one of {BACKENDS})")
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs --device cuda; the CPU "
                             "runs over gloo")
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise ValueError(
                f"nccl with {local_ranks} ranks on {cards} card(s): NCCL "
                f"takes one rank a card; launch at most {cards} ranks, or "
                f"ask for --dist_backend gloo to share the cards")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cpu",
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the default process group; True where there is more than one
    process.  Arguments fall back to the launcher's environment; without
    a coordinator there it is a no-op (one process).  ``backend``
    defaults to ``default_backend(device)``."""
    global _host_group
    if dist.is_initialized():
        return dist.get_world_size() > 1
    address = coordinator_address or coordinator_from_env()
    if address is None:
        return False
    world = int(num_processes if num_processes is not None
                else _env("WORLD_SIZE", "NUM_PROCESSES") or 1)
    rank = int(process_id if process_id is not None
               else _env("RANK", "PROCESS_ID") or 0)
    backend = backend or default_backend(device)
    check_backend(backend, device, min(local_world_size(world), world))
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank, timeout=timeout)
    _host_group = (None if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=timeout))
    return world > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Checkpoints, exports, logs and metrics are written by rank 0 only
    (``accelerator.is_main_process``)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op in one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(group=_host_group)


def local_device(device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for ``cuda`` (set as the
    current device), the CPU as it is.  Where the host runs more ranks
    than it has cards (gloo only, ``check_backend``), rank i takes card
    i mod cards, and one line says so."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if device.index is not None and not dist.is_initialized():
        torch.cuda.set_device(device)
        return device
    cards = torch.cuda.device_count()
    local = local_rank()
    if local_world_size() > cards and local == 0:
        print(f"{local_world_size()} ranks share {cards} card(s) over "
              f"{dist.get_backend()}: rank i runs on cuda:(i mod {cards})",
              flush=True)
    device = torch.device("cuda", local % cards)
    torch.cuda.set_device(device)
    return device


def gather_to_host(x) -> np.ndarray:
    """Every rank's array (the same shape on each), stacked in rank order
    on a new first axis, on every rank; ``x[None]`` in one process."""
    arr = np.ascontiguousarray(np.asarray(x))
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return arr[None]
    t = torch.from_numpy(arr.copy())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t, group=_host_group)
    return np.stack([p.numpy() for p in parts])


def shutdown() -> None:
    """Leave the process group where one was joined."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None
