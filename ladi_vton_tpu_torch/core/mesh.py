"""The data x model layout of the ranks, as process groups.

Counterpart of ``ladi_vton_tpu/core/mesh.py``.  The JAX package lays its
devices out as a ``("data", "model")`` mesh in one process; the port has
one process per rank, laid out the same way: rank ``d * model + m`` sits
at data index d and model index m (the JAX ``reshape(data, model)``).
``make_mesh`` returns this rank's place and two process groups:

* ``data_group``: the ranks with this rank's model index (the gradient
  mean and ZeRO-1 run over it);
* ``model_group``: the ranks with this rank's data index (tensor
  parallelism's collectives run over it).

In one process without a process group both groups are None and every
collective over them is skipped; a process group of one rank (NCCL's
init at world size 1) still runs them.  ``shard_batch`` takes this
rank's rows of a global batch.  The JAX ``replicate`` has no
counterpart: every rank builds or loads the same parameters.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Optional

import torch
import torch.distributed as dist

from ladi_vton_tpu_torch.core.distributed import DEFAULT_TIMEOUT


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; ``data * model`` must equal the world size,
    and ``data = -1`` takes the ranks left over."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        data = self.data if self.data != -1 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices")
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the data x model layout."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_ranks: tuple
    model_ranks: tuple
    data_group: Any = None
    model_group: Any = None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` along ``data``."""
        if n % self.data:
            raise ValueError(f"a batch of {n} does not divide over the "
                             f"data axis of {self.data}")
        per = n // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def make_mesh(spec: MeshSpec = MeshSpec(),
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """This rank's ``Mesh`` over the default process group (one rank
    without one).  Collective: every rank makes every group, in one
    order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data, model = spec.resolve(world)
    d, m = divmod(rank, model)
    data_ranks = tuple(i * model + m for i in range(data))
    model_ranks = tuple(d * model + j for j in range(model))
    data_group = model_group = None
    if dist.is_initialized():
        for j in range(model):
            ranks = [i * model + j for i in range(data)]
            group = dist.new_group(ranks, timeout=timeout)
            if j == m:
                data_group = group
        for i in range(data):
            ranks = [i * model + j for j in range(model)]
            group = dist.new_group(ranks, timeout=timeout)
            if i == d:
                model_group = group
    return Mesh(data=data, model=model, data_index=d, model_index=m,
                data_ranks=data_ranks, model_ranks=model_ranks,
                data_group=data_group, model_group=model_group)


def single() -> Mesh:
    """The one-rank mesh (no process group)."""
    return Mesh(1, 1, 0, 0, (0,), (0,))


def shard_batch(mesh: Optional[Mesh], tree):
    """This rank's rows (axis 0, over ``data``) of every array or list of
    a global batch; lists and tuples (names, categories) too."""
    if mesh is None or mesh.data == 1:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    return tree[mesh.rows(len(tree))]


def all_reduce_mean(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """``t`` averaged over ``group`` (of ``size`` ranks), in fp32; ``t``
    itself where there is no group."""
    if group is None:
        return t
    out = t.detach().float().clone()
    dist.all_reduce(out, group=group)
    return (out / size).to(t.dtype)
