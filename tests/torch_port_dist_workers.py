"""What the distributed tests run on each rank.

These functions import torch and the port only (no JAX), so that the
ranks ``ladi_vton_tpu_torch.parallel.launch.spawn`` starts come up fast;
the tests that spawn them hold the results to the JAX package.  A payload
carries the towers' configurations and state dicts, the global batch and
the global draws; each rank takes its rows.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ladi_vton_tpu_torch.core import distributed
from ladi_vton_tpu_torch.core.checkpoint import CheckpointManager
from ladi_vton_tpu_torch.core import mesh as mesh_mod
from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh, shard_batch
from ladi_vton_tpu_torch.diffusion.schedulers import make_scheduler
from ladi_vton_tpu_torch.models import clip
from ladi_vton_tpu_torch.models.emasc import EMASC
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.unet_condition import (
    UNet2DCondition,
    UNetConfig,
)
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ladi_vton_tpu_torch.parallel import sharding, tp
from ladi_vton_tpu_torch.pipelines import graphs
from ladi_vton_tpu_torch.pipelines.serving import TryOnService
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from ladi_vton_tpu_torch.train import steps

torch.set_num_threads(1)
LR = 1e-5  # the reference's learning rate
SAMPLE_ARGS = ("image", "mask_image", "pose_map", "warped_cloth",
               "prompt_embeds", "negative_prompt_embeds")


def probe(workdir: str) -> dict:
    """The rank's place, a gather and a file written by rank 0 only."""
    g = distributed.gather_to_host(
        np.full(2, distributed.rank(), np.float32))
    if distributed.is_main_process():
        marker = Path(workdir) / "marker.txt"
        marker.write_text(marker.read_text() + f"rank{distributed.rank()}"
                          if marker.exists() else f"rank{distributed.rank()}")
    distributed.barrier()
    return {"rank": distributed.rank(), "world": distributed.world_size(),
            "local_rank": distributed.local_rank(),
            "main": distributed.is_main_process(),
            "gathered": g.reshape(-1).tolist()}


def towers(p: dict) -> dict:
    """The port's towers of the payload, with its state dicts."""
    unet = UNet2DCondition(UNetConfig(**p["unet_cfg"]))
    vae = AutoencoderKL(VAEConfig(**p["vae_cfg"]))
    text = clip.CLIPTextModel(clip.CLIPTextConfig(**p["text_cfg"]))
    adapter = InversionAdapter(
        vision_config=clip.CLIPVisionConfig(**p["vision_cfg"]),
        **p["adapter_cfg"])
    out = {"unet": unet, "vae": vae, "text_model": text,
           "inversion_adapter": adapter}
    for name, module in out.items():
        module.load_state_dict(p["state"][name])
        module.eval().requires_grad_(name == "unet")
    return out


def _loss(p: dict, t: dict):
    return steps.make_vto_loss(
        config=steps.VTOStepConfig(**p["step_cfg"]),
        empty_prompt_ids=p["empty"], **t)


def _rows(mesh, tree: dict, n: int) -> dict:
    rows = mesh.rows(n)
    return {k: v[rows] for k, v in tree.items()}


def dp_grads(p: dict) -> dict:
    """The data-parallel step's loss and gradients (lr 0, no clip: the
    parameters' ``.grad`` stay the step's reduced gradients)."""
    mesh = make_mesh(MeshSpec())
    t = towers(p)
    opt = steps.Optimizer(list(t["unet"].parameters()), lambda count: 0.0)
    step = steps.build_train_step(_loss(p, t), opt, mesh=mesh)
    n = len(p["batch"]["image"])
    metrics = step(shard_batch(mesh, p["batch"]), _rows(mesh, p["draws"], n))
    return {"loss": float(metrics["loss"]),
            "grads": {k: v.grad.clone()
                      for k, v in t["unet"].named_parameters()}}


def _adamw(params, mesh, zero: bool):
    return steps.make_optimizer(params, LR, warmup_steps=0,
                                weight_decay=1e-2, max_grad_norm=1.0,
                                mesh=mesh, shard_optimizer_states=zero)


def zero_runs(p: dict, workdir: str) -> dict:
    """One AdamW step unsharded and under ZeRO-1 from the same state (the
    updated UNets, the AdamW elements each rank holds), then two steps
    under ZeRO-1 uninterrupted and with a save, a restore into fresh
    modules and optimizer, and the second step (the two final UNets);
    whether this rank got the checkpoint's state, and the AdamW elements it
    holds after the restore."""
    mesh = make_mesh(MeshSpec())
    n = len(p["batch"]["image"])
    batch = shard_batch(mesh, p["batch"])
    out = {}
    for zero in (False, True):
        t = towers(p)
        opt = _adamw(list(t["unet"].parameters()), mesh, zero)
        steps.build_train_step(_loss(p, t), opt, mesh=mesh)(
            batch, _rows(mesh, p["draws"], n))
        out[zero] = {k: v.detach().clone()
                     for k, v in t["unet"].state_dict().items()}
        out[f"numel_{zero}"] = opt.local_state_numel()

    def run(resume: bool) -> dict:
        t = towers(p)
        opt = _adamw(list(t["unet"].parameters()), mesh, True)
        step = steps.build_train_step(_loss(p, t), opt, mesh=mesh)
        step(batch, _rows(mesh, p["draws"], n))
        if resume:
            from ladi_vton_tpu_torch.cli.train_vto import (
                checkpoint_state,
                resume as restore,
            )

            modules = {"unet": t["unet"]}
            mgr = CheckpointManager(workdir, async_save=True)
            state = checkpoint_state(1, modules, opt, mesh)
            out["saved_on_rank"] = state is not None
            if distributed.is_main_process():
                mgr.save(1, state)
                mgr.wait()
            distributed.barrier()
            t = towers(p)
            opt = _adamw(list(t["unet"].parameters()), mesh, True)
            step = steps.build_train_step(_loss(p, t), opt, mesh=mesh)
            assert restore(mgr, "latest", {"unet": t["unet"]}, opt,
                           _Quiet(), mesh) == 1
            out["restored_numel"] = opt.local_state_numel()
            out["wrapper_state"] = len(opt.adamw.state)
        step(batch, _rows(mesh, p["draws2"], n))
        return {k: v.detach().clone()
                for k, v in t["unet"].state_dict().items()}

    out["uninterrupted"] = run(False)
    out["resumed"] = run(True)
    return out


class _Quiet:
    def info(self, msg: str) -> None:
        pass


def tp_runs(p: dict) -> dict:
    """At data 1 x model ``p["model"]`` (2 by default): the
    tensor-parallel UNet's forward on the payload's inputs, then, unless
    ``p["step"]`` is false, the TP step's loss and its gradients gathered
    to the reference layout (lr 0, no clip)."""
    mesh = make_mesh(MeshSpec(data=1, model=p.get("model", 2)))
    t = towers(p)
    unet = tp.unet_tp(t["unet"], mesh)
    q = unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q
    with torch.no_grad():
        forward = unet(*p["forward"])
    out = {"forward": forward, "q_shape": tuple(q.weight.shape),
           "sharded": sorted(k for k, v in unet.named_parameters()
                             if getattr(v, "tp_sharded", False))}
    if not p.get("step", True):
        return out
    opt = steps.make_optimizer(list(unet.parameters()), 0.0,
                               max_grad_norm=None, warmup_steps=0,
                               mesh=mesh)
    step = steps.build_train_step(_loss(p, t), opt, mesh=mesh)
    metrics = step(p["batch"], p["draws"])
    grads = tp.gather_unet_state(unet, mesh, {
        k: v.grad for k, v in unet.named_parameters()})
    local = {k: v.grad.clone() for k, v in unet.named_parameters()
             if not getattr(v, "tp_sharded", False)}
    return {**out, "loss": float(metrics["loss"]), "grads": grads,
            "replicated_grads": local}


def dp_and_zero(p: dict, workdir: str) -> dict:
    """``dp_grads`` then ``zero_runs`` in one rank process."""
    return {"dp": dp_grads(p), "zero": zero_runs(p, workdir)}


def each(target: str, calls: list) -> list:
    """This module's ``target`` on each argument tuple of ``calls`` in
    turn: several runs for one start-up of the ranks."""
    return [globals()[target](*args) for args in calls]


def single_grads(p: dict) -> dict:
    """The single-process port step's loss and gradients (lr 0)."""
    t = towers(copy.deepcopy(p))
    opt = steps.Optimizer(list(t["unet"].parameters()), lambda count: 0.0)
    metrics = steps.build_train_step(_loss(p, t), opt)(p["batch"],
                                                        p["draws"])
    return {"loss": float(metrics["loss"]),
            "grads": {k: v.grad.clone()
                      for k, v in t["unet"].named_parameters()}}


def serve_rank(p: dict) -> dict:
    """A ``TryOnService`` over the payload's mesh around the payload's
    try-on pipeline.  Rank 0: the payload's padded batch with its global
    draws (``sample_batch``) where it holds them, then ``idle_s`` seconds
    of nothing, then one request (request 0 of ``seed``), then ``close``;
    the other ranks follow until the stop.  Each rank's seconds in
    ``follow`` come back too."""
    mesh = make_mesh(MeshSpec(**p["mesh"]))
    unet = UNet2DCondition(UNetConfig(**p["unet_cfg"]))
    vae = AutoencoderKL(VAEConfig(**p["vae_cfg"]))
    emasc = EMASC(*p["emasc_cfg"])
    for module, name in ((unet, "unet"), (vae, "vae"), (emasc, "emasc")):
        module.load_state_dict(p["state"][name])
        module.eval()
    pipe = TryOnPipeline(unet=tp.unet_tp(unet, mesh), vae=vae, emasc=emasc,
                         scheduler=make_scheduler("ddim"))
    service = TryOnService(pipe, mesh=mesh, **p["service"])
    if not distributed.is_main_process():
        t0 = time.monotonic()
        service.follow()
        return {"followed_s": time.monotonic() - t0}
    out = {}
    if "noise" in p:
        out["sample_batch"] = service.sample_batch(p["padded"], p["noise"])
    time.sleep(p["idle_s"])
    out["generate"] = service.generate(**p["request"])
    service.close()
    return out


# ------------------------------------------------- the staged step


@contextlib.contextmanager
def recording(calls: list):
    """``torch.distributed.all_reduce`` and ``broadcast`` wrapped to add
    (name, the train program's stage at the call) to ``calls``."""
    dist = torch.distributed
    real = {name: getattr(dist, name) for name in ("all_reduce", "broadcast")}

    def wrapped(name: str):
        def call(*args, **kw):
            calls.append((name, mesh_mod.current_stage()))
            return real[name](*args, **kw)
        return call

    for name in real:
        setattr(dist, name, wrapped(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def single_body_step(loss_fn, opt, A: int, mesh):
    """The step over ranks as one body, as the port ran it before its
    stages: the micro-batches, the gradients' mean, the clip,
    ``ZeroRedundancyOptimizer``'s whole step (its local step and its
    broadcasts) or AdamW's, the metrics' mean; the learning rate written
    before and the count advanced after."""
    def step(batch: dict, draws: dict) -> dict:
        opt.write_lr()
        opt.zero_grad()
        total: dict = {}
        parts = (zip(steps._split(batch, A), steps._split(draws, A))
                 if A > 1 else [(batch, draws)])
        for mb, md in parts:
            loss, _ = loss_fn(mb, md)
            (loss / A).backward()
            v = loss.detach().float()
            total["loss"] = total["loss"] + v if "loss" in total else v
        steps.reduce_gradients(opt.params, mesh)
        opt.clip()
        opt.adamw.step()
        opt.advance()
        return {k: mesh_mod.all_reduce_mean(v / A, mesh.data_group,
                                            mesh.data)
                for k, v in total.items()}
    return step


def _point(params, grads) -> None:
    for q, g in zip(params, grads):
        q.grad = g


class FixedGrads:
    """Graph stand-ins (``Graph``'s arguments) whose gradients stay in
    fixed tensors, as a CUDA graph's stay in its pool.  The gradient
    stage's capture runs it once, and the gradients that run leaves are
    the graph's own; a replay runs it again, copies the new gradients into
    the graph's own and leaves every ``.grad`` where it found it, since a
    replay runs no Python.  The update's capture runs nothing and keeps
    the gradients it sees; a replay updates from those."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def __call__(self, body, *args, stream=None, pool=None,
                 warm: bool = True):
        return _FixedGradGraph(self.optimizer, body, args)


class _FixedGradGraph:
    def __init__(self, optimizer, body, args):
        self.params, self.body, self.args = optimizer.params, body, args
        self.is_update, self.pool = body == optimizer.update, None
        self.outputs = None if self.is_update else body(*args)
        self.grads = [q.grad for q in self.params]

    def replay(self):
        found = [q.grad for q in self.params]
        if self.is_update:
            _point(self.params, self.grads)
            self.body()
        else:
            out = self.body(*self.args)
            for g, q in zip(self.grads, self.params):
                if g is not None:
                    g.copy_(q.grad)
            for k, v in out.items():
                self.outputs[k].copy_(v)
        _point(self.params, found)
        return self.outputs


class StaleReduce(graphs.StagedTrainStep):
    """A planted revert: the staged step as it ran before each signature
    kept its gradients, the reduce reading whatever ``.grad`` points at."""

    def run(self):
        out = self.gradients.replay()
        self.seams.reduce()
        self.update.replay()
        return self.seams.finish(out)


class _Stream:
    device = torch.device("cpu")

    def wait_stream(self, other) -> None:
        pass


class CPUStagedProgram(graphs.TrainProgram):
    """A staged program whose per-signature path runs on the CPU: the
    first call the real step, then ``staged`` (``StagedTrainStep``) over
    ``graph``'s stand-ins (``FixedGrads`` by default), replayed by later
    calls.  ``stand_in`` patches the CUDA
    calls the path makes."""

    def __init__(self, program: graphs.TrainProgram, graph=None,
                 staged=graphs.StagedTrainStep):
        super().__init__(program.body, optimizer=program.optimizer,
                         device="cpu", modules=program.modules,
                         seams=program.seams)
        self.graphed, self.stream = True, _Stream()
        self.graph = FixedGrads(program.optimizer) if graph is None else graph
        self.staged = staged

    def capture(self, inputs: tuple):
        step = self.staged(self, inputs, self.stream, graph=self.graph)
        self.optimizer.captured = True
        return step


@contextlib.contextmanager
def stand_in():
    cuda = torch.cuda
    real = {name: getattr(cuda, name) for name in
            ("current_stream", "stream", "synchronize", "empty_cache")}
    cuda.current_stream = lambda device=None: None
    cuda.stream = lambda stream: contextlib.nullcontext()
    cuda.synchronize = cuda.empty_cache = lambda device=None: None
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(cuda, name, fn)


def _unet_state(t: dict) -> dict:
    return {k: v.detach().clone() for k, v in t["unet"].state_dict().items()}


def _staged_form(p: dict, mesh, zero: bool, A: int, kind: str) -> dict:
    """Three steps of one form from the payload's state: ``kind``
    "single" (``single_body_step``), "staged" (the program, its stages
    run in order) or "per_signature" (``CPUStagedProgram``); each step's
    loss and UNet, the collectives by stage, the program's form."""
    t = towers(p)
    opt = _adamw(list(t["unet"].parameters()), mesh, zero)
    loss_fn = _loss(p, t)
    program = steps.build_train_step(loss_fn, opt, A, mesh=mesh)
    out = {"seams": program.seams is not None,
           "eager_reason": program.eager_reason, "calls": [],
           "losses": [], "unets": []}
    if kind == "single":
        step = single_body_step(loss_fn, opt, A, mesh)
    elif kind == "per_signature":
        step = CPUStagedProgram(program)
    else:
        step = program
    n = len(p["batches"][0]["image"])
    with recording(out["calls"]), stand_in():
        for batch, draws in zip(p["batches"], p["step_draws"]):
            metrics = step(shard_batch(mesh, batch), _rows(mesh, draws, n))
            out["losses"].append(metrics["loss"].clone())
            out["unets"].append(_unet_state(t))
    if kind == "per_signature":
        out["signatures"] = len(step.sets)
    out["count"] = opt.count
    return out


def _signature_form(p: dict, mesh, zero: bool, kind: str) -> dict:
    """The steps of ``p["signature_batches"]`` (two batch shapes, A, B,
    A) from the payload's state: ``kind`` "single" (``single_body_step``),
    "fixed" (``CPUStagedProgram``) or "stale" (the same with
    ``StaleReduce``); each step's loss and UNet."""
    t = towers(p)
    opt = _adamw(list(t["unet"].parameters()), mesh, zero)
    loss_fn = _loss(p, t)
    program = steps.build_train_step(loss_fn, opt, mesh=mesh)
    if kind == "single":
        step = single_body_step(loss_fn, opt, 1, mesh)
    else:
        step = CPUStagedProgram(program, staged=StaleReduce if kind ==
                                "stale" else graphs.StagedTrainStep)
    out = {"losses": [], "unets": []}
    with stand_in():
        for batch, draws in zip(p["signature_batches"],
                                p["signature_draws"]):
            n = len(batch["image"])
            metrics = step(shard_batch(mesh, batch), _rows(mesh, draws, n))
            out["losses"].append(metrics["loss"].clone())
            out["unets"].append(_unet_state(t))
    if kind != "single":
        out["signatures"] = len(step.sets)
    return out


def _planted(p: dict, mesh, what: str) -> dict:
    """One data-parallel step with a collective planted into the
    gradient stage: ``what`` "reduce_gradients" (the gradients' mean moved
    there from between the stages) or "all_reduce" (a bare
    ``torch.distributed.all_reduce``, which no guard of the port's sees);
    the collectives by stage and the error raised, if any."""
    t = towers(p)
    opt = _adamw(list(t["unet"].parameters()), mesh, False)
    program = steps.build_train_step(_loss(p, t), opt, mesh=mesh)
    body = program.body

    def moved(batch, draws):
        metrics = body(batch, draws)
        if what == "reduce_gradients":
            steps.reduce_gradients(opt.params, mesh)
        else:
            torch.distributed.all_reduce(next(
                q.grad for q in opt.params if q.grad is not None),
                group=mesh.data_group)
        return metrics

    planted = graphs.TrainProgram(
        moved, optimizer=opt, device="cpu",
        seams=graphs.Seams(lambda: None, program.seams.finish))
    out = {"calls": [], "error": None}
    n = len(p["batches"][0]["image"])
    with recording(out["calls"]):
        try:
            planted(shard_batch(mesh, p["batches"][0]),
                    _rows(mesh, p["step_draws"][0], n))
        except RuntimeError as e:
            out["error"] = str(e)
    return out


def staged_runs(p: dict) -> dict:
    """For each (zero, A) of ``p["forms"]``: three steps of the staged
    program, its stages run in order, and of ``single_body_step`` from
    the same state; for each of ``p["per_signature"]`` the same three
    steps through ``CPUStagedProgram``; then the planted collectives;
    then, for data parallelism and ZeRO-1, ``_signature_form``'s three
    kinds."""
    mesh = make_mesh(MeshSpec())
    out = {}
    for zero, A in p["forms"]:
        kinds = ["staged", "single"] + (
            ["per_signature"] if (zero, A) in p["per_signature"] else [])
        for kind in kinds:
            out[(zero, A, kind)] = _staged_form(p, mesh, zero, A, kind)
    for what in ("reduce_gradients", "all_reduce"):
        out[("planted", what)] = _planted(p, mesh, what)
    for zero in (False, True):
        for kind in ("single", "fixed", "stale"):
            out[("signatures", zero, kind)] = _signature_form(p, mesh, zero,
                                                              kind)
    return out


# ------------------------------------------ the sampler over a model axis


class RecordedGraph:
    """A ``torch.cuda.CUDAGraph`` stand-in for the CPU: between
    ``capture_begin`` and ``capture_end`` it runs the operations and
    records each ATen call with its tensors; ``replay`` runs the recorded
    calls again over the same tensors, writing each result into the
    tensor the capture made, as a graph reads and writes fixed memory.
    Each collective recorded (a ``c10d`` operation) is also kept in
    ``collectives``."""

    def __init__(self):
        self.calls, self.collectives = [], []
        self._pool = self._mode = None

    def capture_begin(self, pool=None, capture_error_mode=None):
        self._pool = id(self) if pool is None else pool
        self._mode = _Recorder(self)
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)

    def pool(self):
        return self._pool

    def replay(self):
        for func, args, kwargs, out in self.calls:
            fresh = func(*args, **kwargs)
            for old, new in zip(tree_leaves(out), tree_leaves(fresh)):
                if (isinstance(old, torch.Tensor)
                        and old.data_ptr() != new.data_ptr()):
                    old.copy_(new)


class _Recorder(TorchDispatchMode):
    def __init__(self, graph: RecordedGraph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("c10d", "_c10d_functional"):
            self.graph.collectives.append(str(func))
        self.graph.calls.append((func, args, kwargs, out))
        return out


def recorded(sampler):
    """``sampler`` (a ``pipelines.graphs.Sampler``) capturing and
    replaying on the CPU, its graphs ``RecordedGraph``s (under
    ``stand_in``)."""
    sampler.graphed, sampler.stream = True, _Stream()
    sampler.graph = functools.partial(graphs.Graph, make=RecordedGraph)
    return sampler


@contextlib.contextmanager
def reductions(calls: list, skip: int = -1):
    """``torch.distributed.all_reduce`` wrapped to add (the stage at the
    call, the tensor's shape) to ``calls``; the call numbered ``skip``
    (from 0) is recorded and not run (a planted fault)."""
    dist = torch.distributed
    real = dist.all_reduce

    def call(t, *args, **kw):
        calls.append((mesh_mod.current_stage(), tuple(t.shape)))
        if len(calls) - 1 != skip:
            return real(t, *args, **kw)

    dist.all_reduce = call
    try:
        yield
    finally:
        dist.all_reduce = real


def _tp_pipe(p: dict, mesh) -> TryOnPipeline:
    unet = UNet2DCondition(UNetConfig(**p["unet_cfg"]))
    vae = AutoencoderKL(VAEConfig(**p["vae_cfg"]))
    emasc = EMASC(*p["emasc_cfg"])
    for module, name in ((unet, "unet"), (vae, "vae"), (emasc, "emasc")):
        module.load_state_dict(p["state"][name])
        module.eval()
    return TryOnPipeline(unet=tp.unet_tp(unet, mesh), vae=vae, emasc=emasc,
                         scheduler=make_scheduler("ddim"))


def tp_sample_runs(p: dict) -> dict:
    """At data 1 x model 2: for each of ``p["requests"]`` ((args, noise)),
    ``pipe.sample`` (its ``all_reduce``s recorded), ``make_sampler``'s
    sampler, and the same sampler capturing in pieces on the CPU
    (``recorded``; its first call captures, the second replays), its
    ``all_reduce``s recorded; the step graph's pieces and cuts.  Then the
    planted faults: the second request replayed with one cut's
    ``all_reduce`` skipped, and an ``all_reduce_mean`` planted in the
    step, which must raise at the capture."""
    mesh = make_mesh(MeshSpec(data=1, model=2))
    pipe = _tp_pipe(p, mesh)
    static = p["static"]
    sampler = sharding.make_sampler(pipe, mesh, **static)
    pieces = recorded(sharding.make_sampler(pipe, mesh, **static))
    out = {"kind": type(sampler).__name__, "mode": sampler.mode,
           "graphed": sampler.graphed, "eager": [], "sampled": [],
           "made": [], "pieces": [], "piece_calls": []}
    for args, noise in p["requests"]:
        calls: list = []
        with reductions(calls):
            out["sampled"].append(pipe.sample(
                **dict(zip(SAMPLE_ARGS, args)), noise=noise, **static))
        out["eager"].append(calls)
        out["made"].append(sampler(*args, noise=noise))
        calls = []
        with stand_in(), reductions(calls):
            out["pieces"].append(pieces(*args, noise=noise).clone())
        out["piece_calls"].append(calls)
    (loop,) = pieces.sets.values()
    out["graphs"] = [{"pieces": len(g.pieces),
                      "cut_shapes": [tuple(t.shape) for t, _ in g.cuts],
                      "collectives": [c for piece in g.pieces
                                      for c in piece.collectives]}
                     for g in loop.graphs]
    args, noise = p["requests"][1]
    with stand_in(), reductions([], skip=p["skip"]):
        out["skipped"] = pieces(*args, noise=noise).clone()

    planted = recorded(sharding.make_sampler(pipe, mesh, **static))
    step = planted.plan.step

    def step_with_mean(latents, *rest):
        latents = mesh_mod.all_reduce_mean(latents, mesh.model_group,
                                           mesh.model)
        return step(latents, *rest)

    planted.plan.step = step_with_mean
    out["planted_error"] = None
    try:
        with stand_in():
            planted(*args, noise=noise)
    except RuntimeError as e:
        out["planted_error"] = str(e)
    return out
