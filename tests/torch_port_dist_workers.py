"""What the distributed tests run on each rank.

These functions import torch and the port only (no JAX), so that the
ranks ``ladi_vton_tpu_torch.parallel.launch.spawn`` starts come up fast;
the tests that spawn them hold the results to the JAX package.  A payload
carries the towers' configurations and state dicts, the global batch and
the global draws; each rank takes its rows.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path

import numpy as np
import torch

from ladi_vton_tpu_torch.core import distributed
from ladi_vton_tpu_torch.core.checkpoint import CheckpointManager
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
from ladi_vton_tpu_torch.parallel import tp
from ladi_vton_tpu_torch.pipelines.serving import TryOnService
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from ladi_vton_tpu_torch.train import steps

torch.set_num_threads(1)
LR = 1e-5  # the reference's learning rate


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
