"""Training steps of the extended-UNet and EMASC stages.

Counterpart of ``ladi_vton_tpu/train/steps.py``.  A step,
``step(batch, draws) -> metrics``, runs the loss of each micro-batch,
``backward``, and one optimizer update.  It is a
``pipelines.graphs.TrainProgram``, the JAX ``jax.jit`` of the step: on
the card its first call per input signature is the real step, run
eagerly, after which the step is captured as a CUDA graph that later
calls replay (forward, backward, clip and AdamW inside the graph, the
learning rate written before each replay).  Over the data axis of a
mesh (the JAX ``shard_step``) it is two captured stages, the gradients'
and the update's, with the collectives run eagerly between and after
them; at a model axis above 1 it runs eagerly (``eager_reason``), and on
the CPU every form runs its stages eagerly, in order.

* The optimizer (``make_optimizer``) is AdamW after a global-norm clip,
  matched to optax's ``chain(clip_by_global_norm, adamw(schedule))``:
  the clip scales by ``max_norm / norm`` where the norm reaches
  ``max_norm`` (``clip_grad_norm_`` would divide by ``norm + 1e-6``), and
  the learning rate of update n (from 0) is ``schedule(n)``, the count
  before the increment, as optax evaluates it; so the first update of a
  warmup has lr 0.  ``make_lr_schedule`` is the six schedules of the JAX
  package, over update counts.
* Randomness is an argument: every loss takes ``draws``, a dict of
  tensors whose first axis is the batch's (the posterior noise of each
  VAE encode, the diffusion noise, the timesteps, the three dropout
  uniforms), so a test can hand it the JAX package's draws.  The trainers
  make them with ``vto_draws`` and friends from a ``torch.Generator``
  (``core.rng.batch_generator``): the streams differ from JAX's, as in
  serving.
* Gradient accumulation (``build_train_step``): the batch and its draws
  split into A micro-batches along the first axis, each loss is
  back-propagated scaled by 1/A, and one update follows; the metrics are
  the micro-batches' mean, as the JAX ``lax.scan`` gives them.
* Data parallelism (``build_train_step(..., mesh=)``, the JAX
  ``shard_step``): each rank runs its rows of the global batch, and after
  the last micro-batch's backward one bucketed ``all_reduce`` averages
  the gradients over the mesh's ``data`` group, so the update is the one
  of the global batch's mean loss (the JAX ``psum``); the clip then sees
  the same reduced gradients on every rank, and the metrics are averaged
  over ``data``.  That ``all_reduce`` sits between the step's two
  stages, and ZeRO-1's broadcasts and the metrics' mean after the second
  (``build_train_step``).
* ZeRO-1 (``Optimizer(..., zero_group=)``, the JAX
  ``zero1_state_sharding``): the parameters stay replicated and the AdamW
  moments are sharded over ``data`` by
  ``torch.distributed.optim.ZeroRedundancyOptimizer``: each rank updates
  the parameters it owns (``Optimizer.update``, captured) and broadcasts
  them (``Optimizer.sync``, eager).  AdamW's arithmetic is per
  element, so the update is bitwise the unsharded one.
* Tensor parallelism (``parallel.tp``): parameters marked ``tp_sharded``
  are one rank's slice; the clip's global norm adds their squares over
  the ``model`` group (``Optimizer(..., model_group=)``).
* Mixed precision: the trainable towers keep fp32 parameters, and the
  step runs under ``torch.autocast(dtype=torch.bfloat16)`` where the
  policy is bf16.  Autocast runs the convolutions and matmuls in bf16,
  and the kernel wrappers' autograd Functions cast their inputs to bf16
  on entry (``torch.amp.custom_fwd(cast_inputs=torch.bfloat16)``, see
  ``ops._autograd``): the cast is in the Functions, and the gradients
  reach the fp32 parameters through it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ladi_vton_tpu_torch.core.mesh import Mesh, all_reduce_mean, outside_stage
from ladi_vton_tpu_torch.diffusion.schedulers import DDPMScheduler
from ladi_vton_tpu_torch.diffusion.text import encode_text_word_embedding
from ladi_vton_tpu_torch.models.emasc import mask_features
from ladi_vton_tpu_torch.models.vae import DiagonalGaussian
from ladi_vton_tpu_torch.models.vgg import vgg_loss
from ladi_vton_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from ladi_vton_tpu_torch.pipelines.graphs import Seams, TrainProgram
from ladi_vton_tpu_torch.pipelines.tryon import _nchw as nchw

LR_SCHEDULERS = ("linear", "cosine", "cosine_with_restarts", "polynomial",
                 "constant", "constant_with_warmup")


# ------------------------------------------------------------ optimizer


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def make_lr_schedule(name: str, lr: float, warmup_steps: int = 0,
                     total_steps: Optional[int] = None,
                     lr_end: float = 1e-7,
                     power: float = 1.0) -> Callable[[int], float]:
    """The learning rate of each update count: the diffusers
    ``get_scheduler`` union as the JAX package builds it from optax
    (a linear warmup from 0 joined to the tail at ``warmup_steps``)."""
    if name not in LR_SCHEDULERS:
        raise ValueError(f"unknown lr scheduler {name!r}")
    if name == "constant" or (name == "constant_with_warmup"
                              and warmup_steps <= 0):
        return lambda count: lr
    if name == "constant_with_warmup":
        tail = lambda count: lr  # noqa: E731
    else:
        if total_steps is None:
            raise ValueError(f"lr scheduler {name!r} needs total_steps")
        decay = max(total_steps - warmup_steps, 1)
        if name == "linear":
            tail = _linear(lr, 0.0, decay)
        elif name in ("cosine", "cosine_with_restarts"):
            # optax.cosine_decay_schedule(lr, decay, alpha=0)
            def tail(count):
                c = min(max(count, 0), decay)
                return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        else:
            def tail(count):
                return ((lr - lr_end) * (1 - min(count, decay) / decay)
                        ** power + lr_end)
    if warmup_steps <= 0:
        return tail
    warm = _linear(0.0, lr, warmup_steps)
    # optax.join_schedules: the tail counts from the boundary
    return lambda count: (warm(count) if count < warmup_steps
                          else tail(count - warmup_steps))


class Optimizer:
    """AdamW (``torch.optim.AdamW``) behind an optional global-norm clip,
    stepped with ``schedule(count)`` as its learning rate; ``count`` is
    the number of updates made.  The state dict holds both.

    A step is split so that a CUDA graph can hold its device part:
    ``write_lr`` (host: the schedule's value at ``count`` into the
    learning rate the update reads), ``update`` (device: the clip and the
    AdamW update of this rank's parameters, no host sync), ``sync``
    (collective: ZeRO-1's broadcasts of the updated parameters) and
    ``advance`` (host: ``count`` + 1); ``step`` is the four in order.
    On the card AdamW is capturable: its step counters live on the device
    and ``lr`` is a 0-dim fp32 device tensor that ``write_lr`` fills, so
    a captured update reads each replay's value; the bias correction is
    then computed in fp32 on the device, not in float64 on the host.  On
    the CPU (where PyTorch refuses capturable parameters) AdamW is not
    capturable and ``write_lr`` sets the param groups' float.

    ``zero_group`` (a process group of more than one rank) shards the
    AdamW state over it (ZeRO-1); ``state_dict`` is then collective and
    returns the whole state on the group's first rank, None elsewhere,
    and ``load_state_dict`` takes the whole state on every rank.
    ``model_group``: the group whose ranks hold the other slices of the
    ``tp_sharded`` parameters, for the clip's norm.  ``captured`` is set
    by a program that captured ``update`` (``pipelines.graphs.
    TrainProgram``): loading a state then is refused, since it would
    swap the tensors the graph reads."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], *, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: Optional[float] = None, zero_group=None,
                 model_group=None):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.model_group = model_group
        self.device = (self.params[0].device if self.params
                       else torch.device("cpu"))
        self.capturable = self.device.type == "cuda"
        self.lr = (torch.zeros((), dtype=torch.float32, device=self.device)
                   if self.capturable else None)
        kw = dict(lr=self.lr if self.capturable else 0.0, betas=betas,
                  eps=eps, weight_decay=weight_decay,
                  capturable=self.capturable)
        self.zero_group = zero_group
        if zero_group is not None:
            from torch.distributed.optim import ZeroRedundancyOptimizer

            self.adamw = ZeroRedundancyOptimizer(
                self.params, optimizer_class=torch.optim.AdamW,
                process_group=zero_group, **kw)
        else:
            self.adamw = torch.optim.AdamW(self.params, **kw)
        self._own_groups()
        self.count = 0
        self.captured = False

    def _groups(self) -> list:
        groups = list(self.adamw.param_groups)
        if self.zero_group is not None:
            groups += self.adamw.optim.param_groups
        return groups

    def _own_groups(self) -> None:
        """Every param group reads this optimizer's ``lr`` and
        ``capturable`` (a loaded state dict brings its own)."""
        for group in self._groups():
            group["capturable"] = self.capturable
            if self.lr is not None:
                group["lr"] = self.lr
        # eager updates of a capturable AdamW are intended (the first
        # step of a program, steps over ranks): no warning about them
        optims = [self.adamw] + ([self.adamw.optim]
                                 if self.zero_group is not None else [])
        for optim in optims:
            optim._warned_capturable_if_run_uncaptured = True

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def clip(self) -> Optional[torch.Tensor]:
        """optax ``clip_by_global_norm``: g * max_norm / ||g|| where
        ||g|| >= max_norm, without a host sync; returns ||g||."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.max_grad_norm is None or not grads:
            return None
        sharded = [getattr(p, "tp_sharded", False) for p in self.params
                   if p.grad is not None]
        if self.model_group is None or not any(sharded):
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
        else:
            def squares(keep: bool) -> torch.Tensor:
                return sum((torch.linalg.vector_norm(g.float()).square()
                            for g, s in zip(grads, sharded) if s == keep),
                           torch.zeros((), device=grads[0].device))
            part = squares(True)
            outside_stage("the clip's all_reduce over model")
            dist.all_reduce(part, group=self.model_group)
            norm = torch.sqrt(squares(False) + part)
        scale = torch.where(norm < self.max_grad_norm,
                            torch.ones_like(norm), self.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)
        return norm

    def write_lr(self) -> float:
        """The schedule's learning rate at ``count``, written where the
        next ``update`` reads it (a fill on the card: no host sync)."""
        lr = float(self.schedule(self.count))
        if self.lr is not None:
            self.lr.fill_(lr)
        else:
            for group in self._groups():
                group["lr"] = lr
        return lr

    def update(self) -> Optional[torch.Tensor]:
        """The device part of a step: the clip and the AdamW update with
        the learning rate last written, of the parameters this rank owns
        under ZeRO-1 (``ZeroRedundancyOptimizer``'s local step, without
        its broadcasts); returns the clip's norm."""
        norm = self.clip()
        if self.zero_group is not None:
            self.adamw._local_step()
        else:
            self.adamw.step()
        return norm

    def sync(self) -> None:
        """ZeRO-1's collective part of a step: each rank broadcasts the
        parameters it updated (a no-op without ``zero_group``)."""
        if self.zero_group is not None:
            outside_stage("ZeRO-1's parameter broadcasts")
            self.adamw._sync_params()

    def advance(self) -> None:
        self.count += 1

    def step(self) -> Optional[torch.Tensor]:
        self.write_lr()
        norm = self.update()
        self.sync()
        self.advance()
        return norm

    def local_state_numel(self) -> int:
        """Elements of the AdamW state this rank holds."""
        optim = self.adamw.optim if self.zero_group is not None else \
            self.adamw
        return sum(v.numel() for state in optim.state.values()
                   for v in state.values() if torch.is_tensor(v)
                   and v.dim() > 0)

    def state_dict(self) -> Optional[dict]:
        """``{"adamw": ..., "count": n}``; each param group's ``lr`` is a
        float there, so the state loads into either form."""
        adamw = (self._consolidated() if self.zero_group is not None
                 else self.adamw.state_dict())
        if adamw is None:
            return None
        groups = [dict(g, lr=float(g["lr"])) for g in adamw["param_groups"]]
        return {"adamw": dict(adamw, param_groups=groups),
                "count": self.count}

    def _consolidated(self) -> Optional[dict]:
        """ZeRO-1's whole AdamW state in ``torch.optim.AdamW``'s format
        (which ``ZeroRedundancyOptimizer.load_state_dict`` reads) in host
        memory on the group's first rank, None on the others.  Collective:
        each parameter's owner broadcasts its moments as tensors
        (``consolidate_state_dict`` pickles every rank's state through byte
        tensors: minutes for the UNet's 7 GB).  Every rank receives into
        one reused buffer and the first copies each moment out to the
        host, so no rank holds more of the state on its device than its
        shard and one parameter's moment."""
        zero, group = self.adamw, self.zero_group
        me = dist.get_rank(group)
        out = torch.optim.Optimizer.state_dict(zero) if me == 0 else None
        if out is not None:
            out["state"] = {}
        size = max(p.numel() for p in self.params)
        scratch: dict = {}
        for p in self.params:
            owner = zero._param_to_rank[p]
            local = zero.optim.state.get(p, {}) if owner == me else {}
            head = torch.tensor([float(bool(local)), float(local.get(
                "step", 0))], device=p.device)
            src = dist.get_global_rank(group, owner)
            dist.broadcast(head, src=src, group=group)
            if not head[0]:
                continue
            entry = {"step": torch.tensor(float(head[1]))}
            for key in ("exp_avg", "exp_avg_sq"):
                if owner == me:
                    t = local[key]
                else:
                    if p.dtype not in scratch:
                        scratch[p.dtype] = torch.empty(
                            size, dtype=p.dtype, device=p.device)
                    t = scratch[p.dtype][:p.numel()].view_as(p)
                dist.broadcast(t, src=src, group=group)
                if out is not None:
                    entry[key] = t.to("cpu", copy=True)
            if out is not None:
                out["state"][zero._param_to_index[p]] = entry
        return out

    def load_state_dict(self, state: dict) -> None:
        """Load ``state_dict``'s output, from either form; refused once a
        program captured ``update``.  The step counters move to where this
        optimizer keeps them: a saved non-capturable AdamW (on the CPU, or
        on the card before AdamW was capturable) left them on the host, and
        a capturable one reads them on its parameters' device."""
        if self.captured:
            raise RuntimeError(
                "a captured train program reads this optimizer's state in "
                "place; load the state before the program's first call")
        self.adamw.load_state_dict(state["adamw"])
        self._own_groups()
        optim = self.adamw
        if self.zero_group is not None:
            # ZeroRedundancyOptimizer.load_state_dict also leaves a device
            # copy of this rank's moments in the wrapper's own ``state``,
            # which nothing reads: the moments live in ``adamw.optim``
            self.adamw.state.clear()
            optim = self.adamw.optim
        for p, entry in optim.state.items():
            if "step" in entry:
                entry["step"] = entry["step"].to(
                    device=p.device if self.capturable else "cpu",
                    dtype=torch.float32)
        self.count = int(state["count"])


def make_optimizer(params, lr: float = 1e-5, *, adam_beta1=0.9,
                   adam_beta2=0.999, adam_eps=1e-8, weight_decay=1e-2,
                   max_grad_norm=1.0, warmup_steps: int = 0,
                   lr_scheduler: str = "constant_with_warmup",
                   total_steps: Optional[int] = None,
                   mesh: Optional[Mesh] = None,
                   shard_optimizer_states: bool = False) -> Optimizer:
    """AdamW + global-norm clip with the reference's flags (lr 1e-5,
    weight decay 1e-2, clip 1.0) and the lr-scheduler union; over a
    ``mesh``, ZeRO-1 over ``data`` where ``shard_optimizer_states`` and
    the clip's norm over ``model``."""
    zero = (mesh.data_group if mesh is not None and shard_optimizer_states
            and mesh.data > 1 else None)
    model = mesh.model_group if mesh is not None and mesh.model > 1 else None
    return Optimizer(params, make_lr_schedule(lr_scheduler, lr, warmup_steps,
                                              total_steps),
                     betas=(adam_beta1, adam_beta2), eps=adam_eps,
                     weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                     zero_group=zero, model_group=model)


# ------------------------------------------------------------ the step


def precision(device: torch.device, dtype: torch.dtype):
    """The steps' compute context: bf16 autocast where the policy is bf16,
    nothing else for fp32."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(torch.device(device).type, dtype=dtype)


def _split(tree: dict, A: int) -> list[dict]:
    """A micro-batches of every field along its first axis."""
    out = [dict() for _ in range(A)]
    for key, value in tree.items():
        n = len(value) // A
        for i in range(A):
            out[i][key] = value[i * n:(i + 1) * n]
    return out


# elements of one all_reduce bucket of the gradient mean (1 GiB of fp32)
BUCKET_NUMEL = 1 << 28


def reduce_gradients(params, mesh: Optional[Mesh]) -> None:
    """Average the parameters' gradients over the mesh's ``data`` group:
    one ``all_reduce`` a bucket of same-dtype gradients, flattened in
    parameter order (a no-op without a process group)."""
    if mesh is None or mesh.data_group is None:
        return
    outside_stage("the gradients' all_reduce")
    grads = [p.grad for p in params if p.grad is not None]
    buckets: dict = {}
    for g in grads:
        chain = buckets.setdefault((g.dtype, g.device), [[]])
        if chain[-1] and (sum(x.numel() for x in chain[-1]) + g.numel()
                          > BUCKET_NUMEL):
            chain.append([])
        chain[-1].append(g)
    for chain in buckets.values():
        for bucket in chain:
            flat = _flatten_dense_tensors(bucket)
            dist.all_reduce(flat, group=mesh.data_group)
            flat.div_(mesh.data)
            for g, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                g.copy_(r)


def eager_reason(mesh: Optional[Mesh]) -> Optional[str]:
    """Why a step over ``mesh`` runs eagerly on the card, or None where
    it is captured.  At a model axis of 1 every collective of the step
    sits between its stages (the gradient ``all_reduce`` over ``data``)
    or after them (ZeRO-1's broadcasts, the metrics' mean), whatever the
    data axis and the backend.  Above 1 the forward's ``all_reduce``s
    over ``model`` could cut a capture into pieces, as the sampler's do
    (``core.mesh.model_all_reduce``), but the backward's (the gradient
    of every parallel region's input, ``parallel.tp._CopyToModel``) and
    the clip's inside the update cannot yet: the step stays eager."""
    if mesh is None or mesh.model == 1:
        return None
    return (f"a mesh of {mesh.data} x {mesh.model} ranks: the tensor-"
            f"parallel all_reduces of the backward and of the clip are not "
            f"captured")


def build_train_step(loss_fn: Callable, optimizer: Optimizer,
                     gradient_accumulation_steps: int = 1,
                     autocast: Callable = contextlib.nullcontext,
                     mesh: Optional[Mesh] = None,
                     modules: Iterable[torch.nn.Module] = ()
                     ) -> TrainProgram:
    """``step(batch, draws) -> metrics`` from ``loss_fn(batch, draws) ->
    (loss, metrics)``: A micro-batches, each loss back-propagated scaled
    by 1/A, one update; the metrics (tensors, ``loss`` among them) are the
    micro-batches' mean.  ``autocast()`` is the forward's context.  Over a
    ``mesh``, ``batch`` and ``draws`` are this rank's rows, the gradients
    are averaged over ``data`` before the update and the metrics after
    it.

    The step is a ``pipelines.graphs.TrainProgram`` (the JAX
    ``shard_step``'s ``jax.jit``), captured and replayed on the card but
    where ``eager_reason(mesh)`` says why not; ``modules`` are the
    towers the loss runs, checked before the capture.  Without a data
    group it is one stage: ``zero_grad``, the micro-batches, the update.
    Over one (a model axis of 1) it is two stages with the collectives
    between them, as ``pipelines.graphs.Seams`` sets out: the gradient
    stage (``zero_grad``, the micro-batches, this rank's metrics), the
    gradients' ``all_reduce``, the update stage (``optimizer.update``),
    then ZeRO-1's broadcasts and the metrics' mean.  The ``all_reduce``
    looks ``reduce_gradients`` up when it runs."""
    A = gradient_accumulation_steps
    group = mesh.data_group if mesh is not None else None
    size = mesh.data if mesh is not None else 1

    def gradients(batch: dict, draws: Optional[dict] = None) -> dict:
        optimizer.zero_grad()
        parts = (zip(_split(batch, A), _split(draws or {}, A)) if A > 1
                 else [(batch, draws or {})])
        total: dict = {}
        for mb, md in parts:
            with autocast():
                loss, metrics = loss_fn(mb, md)
            (loss / A).backward()
            for k, v in {"loss": loss, **metrics}.items():
                v = v.detach().float()
                total[k] = total[k] + v if k in total else v
        return {k: v / A for k, v in total.items()}

    def reduce() -> None:
        reduce_gradients(optimizer.params, mesh)

    def finish(metrics: dict) -> dict:
        optimizer.sync()
        return {k: all_reduce_mean(v, group, size) for k, v in metrics.items()}

    reason = eager_reason(mesh)
    if group is not None and reason is None:
        zero = ("ZeRO-1's parameter broadcasts and "
                if optimizer.zero_group is not None else "")
        seams = Seams(reduce, finish,
                      f"between them the gradients' all_reduce over "
                      f"{size} data ranks, after them {zero}the metrics' "
                      f"all_reduce")
        return TrainProgram(gradients, optimizer=optimizer,
                            device=optimizer.device, modules=modules,
                            seams=seams)

    def step(batch: dict, draws: Optional[dict] = None) -> dict:
        metrics = gradients(batch, draws)
        reduce()
        optimizer.update()
        return finish(metrics)

    return TrainProgram(step, optimizer=optimizer, device=optimizer.device,
                        modules=modules, eager_reason=reason)


@dataclasses.dataclass(frozen=True)
class VTOStepConfig:
    uncond_fraction: float = 0.2
    num_vstar: int = 16
    text_usage: str = "inversion_adapter"  # | 'noun_chunks' | 'none'
    cloth_input_type: str = "warped"  # | 'none'
    train_inversion_adapter: bool = False
    num_train_timesteps: int = 1000
    gradient_accumulation_steps: int = 1


def _latent_shape(batch: dict) -> tuple:
    B, H, W, _ = batch["image"].shape
    return B, H // 8, W // 8


def vto_draws(batch: dict, generator: torch.Generator, *,
              num_train_timesteps: int = 1000) -> dict:
    """The VTO loss's draws for ``batch``, in a fixed order: posterior
    noise of the image, masked-image and cloth encodes, the diffusion
    noise (NCHW, N(0, 1)), the timesteps (U{0..T-1}) and the uniforms of
    the text, cloth and pose dropout (B, 3)."""
    B, lh, lw = _latent_shape(batch)
    dev = generator.device
    draw = {k: torch.randn((B, 4, lh, lw), generator=generator, device=dev)
            for k in ("latents", "masked", "cloth", "noise")}
    draw["timesteps"] = torch.randint(0, num_train_timesteps, (B,),
                                      generator=generator, device=dev)
    draw["uncond"] = torch.rand((B, 3), generator=generator, device=dev)
    return draw


def make_vto_loss(*, unet, vae, text_model, config: VTOStepConfig,
                  noise_scheduler: Optional[DDPMScheduler] = None,
                  inversion_adapter=None,
                  empty_prompt_ids: Optional[torch.Tensor] = None
                  ) -> Callable:
    """The extended-UNet loss ``(batch, draws) -> (loss, {})``.

    ``batch``: image, im_mask (B,H,W,3), inpaint_mask (B,H,W,1), pose_map
    (B,H,W,18), warped_cloth, input_ids (B,77) and, for the inversion
    adapter, clip_cloth_features (B,S,D), on the towers' device; ``draws``
    as ``vto_draws`` makes them.  The towers that do not train are frozen
    by their ``requires_grad``."""
    cfg = config
    scheduler = noise_scheduler or DDPMScheduler()
    sf = vae.config.scaling_factor

    def encode(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        moments, _ = vae.encode(nchw(x))
        return DiagonalGaussian(moments).sample(noise) * sf

    def loss_fn(batch: dict, draws: dict):
        B, lh, lw = _latent_shape(batch)
        latents = encode(batch["image"], draws["latents"])
        noise = draws["noise"].to(latents.dtype)
        timesteps = draws["timesteps"]
        noisy = scheduler.add_noise(latents, noise, timesteps)
        pose_map = resize_bilinear(nchw(batch["pose_map"]), (lh, lw))
        mask = resize_nearest(nchw(batch["inpaint_mask"]), (lh, lw))
        masked_latents = encode(batch["im_mask"], draws["masked"])
        cloth_latents = (encode(batch["warped_cloth"], draws["cloth"])
                         if cfg.cloth_input_type == "warped" else None)
        input_ids = batch["input_ids"]
        if cfg.uncond_fraction > 0:
            drop = draws["uncond"] < cfg.uncond_fraction  # text, cloth, pose
            if empty_prompt_ids is not None:
                input_ids = torch.where(drop[:, 0:1],
                                        empty_prompt_ids[None, :], input_ids)
            pose_map = torch.where(drop[:, 2, None, None, None],
                                   torch.zeros_like(pose_map), pose_map)
            if cloth_latents is not None:
                cloth_latents = torch.where(drop[:, 1, None, None, None],
                                            torch.zeros_like(cloth_latents),
                                            cloth_latents)
        if cfg.text_usage == "inversion_adapter":
            words = inversion_adapter(batch["clip_cloth_features"])
            ehs, _ = encode_text_word_embedding(text_model, input_ids, words,
                                                cfg.num_vstar)
        else:
            ehs, _ = text_model(input_ids)
        parts = [noisy, mask.to(noisy.dtype), masked_latents,
                 pose_map.to(noisy.dtype)]
        if cloth_latents is not None:
            parts.append(cloth_latents)
        pred = unet(torch.cat(parts, dim=1), timesteps, ehs)
        loss = torch.mean(torch.square(pred.float() - noise.float()))
        return loss, {}

    return loss_fn


def make_vto_train_step(*, optimizer: Optimizer, config: VTOStepConfig,
                        autocast: Callable = contextlib.nullcontext,
                        mesh: Optional[Mesh] = None, **towers) -> Callable:
    """``step(batch, draws)`` of the extended UNet (``make_vto_loss``'s
    towers), with ``config.gradient_accumulation_steps``, over ``mesh``."""
    return build_train_step(make_vto_loss(config=config, **towers),
                            optimizer, config.gradient_accumulation_steps,
                            autocast, mesh, _towers(towers))


def _towers(kwargs: dict) -> list:
    """The modules among a loss's keyword arguments."""
    return [m for m in kwargs.values() if isinstance(m, torch.nn.Module)]


def emasc_draws(batch: dict, generator: torch.Generator) -> dict:
    """The EMASC loss's draw: the image encode's posterior noise."""
    B, lh, lw = _latent_shape(batch)
    return {"latents": torch.randn((B, 4, lh, lw), generator=generator,
                                   device=generator.device)}


def make_emasc_loss(*, vae, emasc, vgg, int_layers=(1, 2, 3, 4, 5),
                    vgg_weight: float = 0.5) -> Callable:
    """EMASC loss: L1(recon, image) + vgg_weight * VGG, the VAE frozen;
    recon decodes the image's latents (unscaled, as the JAX step samples
    them) with the EMASC features of the masked person injected.  batch:
    image, im_mask, inpaint_mask (NHWC)."""

    def loss_fn(batch: dict, draws: dict):
        image = nchw(batch["image"])
        moments, _ = vae.encode(image)
        latents = DiagonalGaussian(moments).sample(draws["latents"])
        _, feats = vae.encode(nchw(batch["im_mask"]))
        adapted = emasc([feats[i] for i in int_layers])
        adapted = mask_features(adapted, nchw(batch["inpaint_mask"]))
        recon = vae.decode(latents, adapted, tuple(int_layers))
        l1 = torch.mean(torch.abs(recon.float() - image.float()))
        perceptual = vgg_loss(vgg, recon, image)
        return l1 + vgg_weight * perceptual, {"l1": l1, "vgg": perceptual}

    return loss_fn


def make_emasc_train_step(*, optimizer: Optimizer,
                          gradient_accumulation_steps: int = 1,
                          autocast: Callable = contextlib.nullcontext,
                          mesh: Optional[Mesh] = None,
                          **kwargs) -> Callable:
    """``step(batch, draws)`` of the EMASC stage (``make_emasc_loss``)."""
    return build_train_step(make_emasc_loss(**kwargs), optimizer,
                            gradient_accumulation_steps, autocast, mesh,
                            _towers(kwargs))
