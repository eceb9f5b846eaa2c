"""The four-phase multi-rank dry run of the training and sampling paths.

Counterpart of the JAX package's ``dryrun_multichip(n_devices)``
(``__graft_entry__.py``), over ranks: ``dryrun_multichip(n, device)``
starts ``n`` ranks itself (``parallel.launch.spawn``, gloo) and each runs

1. the ZeRO-1 VTO train step (the adapter trained too) over a data mesh
   of ``n``: gradients averaged over ``data``, the AdamW state sharded;
2. an asynchronous checkpoint save by rank 0 (consolidated state), a
   restore on every rank into a new sharded optimizer and step program
   (as a restarted run restores: a captured program reads its
   optimizer's state in place and refuses a load), the parameters and
   the update count checked, and a further step;
3. data-parallel sampling as the mains run it: ``drivers.run_batches``
   over one global batch, each rank sampling its rows (``parallel.
   sharding``'s ``local_batch`` and ``sample_draws``) with 2 DDIM steps
   and saving its own items;
4. a data ``n / 2`` x model 2 tensor-parallel train step
   (``parallel.tp``), checking that the updated ``to_q`` weight is still
   a slice.

The towers are tiny but architecturally real, and their attention heads
are 64 wide, so on the card every kernel of the path runs (K1 takes head
dims 64 and 512 only): K1 in the UNet, the VAE and the adapter, K2 and
K5 in every tower, K4 in the UNet's feed-forwards, at ``I / 2`` under
tensor parallelism.  The first level of the UNet has one head, which
stays whole on both model ranks, as SD-2's five do at tp 2.  Each rank
returns its losses, the AdamW elements it holds and its kernel launches
by phase.

    python -m ladi_vton_tpu_torch.parallel.dryrun --ranks 2
    python -m ladi_vton_tpu_torch.parallel.dryrun --ranks 4 --device cpu

The device is the card unless the caller asks for the CPU; asking for
the card where there is none raises before any rank starts.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch

# the tiny towers (head dim 64 wherever K1 runs)
UNET = dict(in_channels=31, block_out_channels=(64, 128, 128, 128),
            layers_per_block=1, head_dim=64, cross_attention_dim=64)
VAE = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=1)
TEXT = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=77)
VISION = dict(hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
              intermediate_size=256)
NUM_VSTAR = 4
H = W = 64  # latents of 8x8 survive the UNet's three downsamples
SEED = 0


def _towers(device, dtype):
    """(unet fp32, adapter fp32, frozen vae and text in ``dtype``), seeded
    the same on every rank."""
    from ladi_vton_tpu_torch.models.clip import (
        CLIPTextConfig,
        CLIPTextModel,
        CLIPVisionConfig,
    )
    from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
    from ladi_vton_tpu_torch.models.unet_condition import (
        UNet2DCondition,
        UNetConfig,
    )
    from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    torch.manual_seed(SEED)
    unet = UNet2DCondition(UNetConfig(**UNET)).to(device)
    vae = AutoencoderKL(VAEConfig(**VAE)).to(device, dtype).eval()
    text = CLIPTextModel(CLIPTextConfig(**TEXT)).to(device, dtype).eval()
    adapter = InversionAdapter(
        input_dim=VISION["hidden_size"], hidden_dim=2 * VISION["hidden_size"],
        output_dim=TEXT["hidden_size"] * NUM_VSTAR, num_encoder_layers=1,
        vision_config=CLIPVisionConfig(**VISION)).to(device).eval()
    vae.requires_grad_(False)
    text.requires_grad_(False)
    return unet, adapter, vae, text


def _batch(n: int, device) -> dict:
    g = torch.Generator().manual_seed(SEED + 1)
    ids = torch.zeros((n, 77), dtype=torch.long)
    ids[:, :4 + NUM_VSTAR] = torch.tensor(
        [510, 7, 8] + [259] * NUM_VSTAR + [511])
    image = torch.rand((n, H, W, 3), generator=g) * 2 - 1
    mask = torch.zeros((n, H, W, 1))
    mask[:, 16:56, 12:52] = 1.0
    batch = {"image": image, "im_mask": image * (1 - mask),
             "inpaint_mask": mask,
             "pose_map": torch.rand((n, H, W, 18), generator=g),
             "warped_cloth": torch.rand((n, H, W, 3), generator=g) * 2 - 1,
             "input_ids": ids,
             "clip_cloth_features": torch.randn(
                 (n, 5, VISION["hidden_size"]), generator=g)}
    return {k: v.to(device) for k, v in batch.items()}


def _launches() -> dict:
    from ladi_vton_tpu_torch.ops.flash_attention import flash_attention
    from ladi_vton_tpu_torch.ops.geglu import geglu
    from ladi_vton_tpu_torch.ops.group_norm import group_norm
    from ladi_vton_tpu_torch.ops.layer_norm import layer_norm

    return {"flash_attention": flash_attention, "group_norm": group_norm,
            "geglu": geglu, "layer_norm": layer_norm}


def _counts() -> dict:
    return {k: f.launches for k, f in _launches().items()}


def _reset() -> None:
    for f in _launches().values():
        f.launches = 0


def _log(phase: str, msg: str) -> None:
    from ladi_vton_tpu_torch.core.distributed import rank, world_size

    print(f"dryrun_multichip({world_size()}) rank {rank()} phase {phase} "
          f"{msg}", flush=True)


def _step_fn(mesh, unet, adapter, vae, text, device, dtype, **opt):
    from ladi_vton_tpu_torch.train.steps import (
        VTOStepConfig,
        make_optimizer,
        make_vto_train_step,
        precision,
    )

    modules = {"unet": unet, "adapter": adapter}
    optimizer = make_optimizer(
        [p for m in modules.values() for p in m.parameters()], 1e-4,
        warmup_steps=0, mesh=mesh, **opt)
    empty = torch.zeros(77, dtype=torch.long, device=device)
    empty[:2] = torch.tensor([510, 511])
    step = make_vto_train_step(
        optimizer=optimizer,
        config=VTOStepConfig(num_vstar=NUM_VSTAR,
                             train_inversion_adapter=True),
        autocast=lambda: precision(device, dtype), mesh=mesh, unet=unet,
        vae=vae, text_model=text, inversion_adapter=adapter,
        empty_prompt_ids=empty)
    return modules, optimizer, step


def _draws(mesh, batch: dict, step: int, device) -> dict:
    from ladi_vton_tpu_torch.core.rng import batch_generator
    from ladi_vton_tpu_torch.train.steps import vto_draws

    draws = vto_draws(batch, batch_generator(SEED, step, device))
    rows = mesh.rows(len(batch["image"]))
    return {k: v[rows] for k, v in draws.items()}


def run_rank(device: str, workdir: str) -> dict:
    """One rank's four phases (``spawn`` runs it on every rank)."""
    from ladi_vton_tpu_torch.core import distributed
    from ladi_vton_tpu_torch.core.checkpoint import CheckpointManager
    from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh, shard_batch
    from ladi_vton_tpu_torch.diffusion.schedulers import DDIMScheduler
    from ladi_vton_tpu_torch.parallel import tp
    from ladi_vton_tpu_torch.parallel.sharding import local_batch, sample_draws
    from ladi_vton_tpu_torch.pipelines.drivers import run_batches
    from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline

    dev = distributed.local_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    n = distributed.world_size()
    B = 2 * n
    out = {"rank": distributed.rank(), "launches": {}}
    batch = _batch(B, dev)

    # --- phase 1: ZeRO-1 train step over a data mesh of n
    mesh = make_mesh(MeshSpec(data=n, model=1))
    unet, adapter, vae, text = _towers(dev, dtype)
    modules, optimizer, step = _step_fn(mesh, unet, adapter, vae, text, dev,
                                        dtype, shard_optimizer_states=True)
    local = shard_batch(mesh, batch)
    _reset()
    loss = float(step(local, _draws(mesh, batch, 0, dev))["loss"])
    out["launches"]["1"] = _counts()
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"phase 1: non-finite loss {loss}")
    total = sum(p.numel() for p in optimizer.params)
    out.update(loss1=loss, adam_numel=optimizer.local_state_numel(),
               param_numel=total)
    _log("1 (ZeRO-1 train step)", f"ok: loss={loss:.4f}, AdamW state "
         f"{out['adam_numel']} of {2 * total} elements on this rank")

    # --- phase 2: async save by rank 0, restore on every rank, a step
    from ladi_vton_tpu_torch.cli.train_vto import checkpoint_state, resume

    mgr = CheckpointManager(workdir, keep=2, async_save=True)
    state = checkpoint_state(1, modules, optimizer, mesh)
    if distributed.is_main_process():
        mgr.save(1, state)
        mgr.wait()
    distributed.barrier()
    before = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    with torch.no_grad():  # the restore must put them back
        for p in unet.parameters():
            p.add_(1.0)
    del step
    modules, optimizer, step = _step_fn(mesh, unet, adapter, vae, text, dev,
                                        dtype, shard_optimizer_states=True)
    restored = resume(mgr, "latest", modules, optimizer,
                      _Quiet(), mesh)
    if restored != 1 or optimizer.count != 1 or not all(
            torch.equal(before[k], v) for k, v in unet.state_dict().items()):
        raise AssertionError("phase 2: the restore did not bring back the "
                             "saved state")
    loss2 = float(step(local, _draws(mesh, batch, 1, dev))["loss"])
    if not torch.isfinite(torch.tensor(loss2)):
        raise AssertionError(f"phase 2: non-finite loss {loss2}")
    out["loss2"] = loss2
    _log("2 (async save, restore, step, sharded)", f"ok: loss={loss2:.4f}")

    # --- phase 3: the mains' data-parallel sampling, 2 DDIM steps
    pipe = TryOnPipeline(unet=unet.to(dtype).eval(), vae=vae,
                         scheduler=DDIMScheduler())
    ctx = torch.zeros((B, 77, TEXT["hidden_size"]), device=dev, dtype=dtype)
    names = [f"{i:02d}.png" for i in range(B)]
    loader = [{"image": batch["image"], "inpaint_mask": batch["inpaint_mask"],
               "pose_map": batch["pose_map"],
               "warped_cloth": batch["warped_cloth"], "ctx": ctx,
               "im_name": names, "category": ["upper_body"] * B}]

    def step_fn(i: int, global_batch: dict) -> torch.Tensor:
        rows, total = local_batch(mesh, global_batch)
        with torch.autocast(dev.type, dtype=dtype,
                            enabled=dev.type == "cuda"):
            images = pipe.sample(
                image=rows["image"], mask_image=rows["inpaint_mask"],
                pose_map=rows["pose_map"], warped_cloth=rows["warped_cloth"],
                prompt_embeds=rows["ctx"], negative_prompt_embeds=rows["ctx"],
                noise=sample_draws(mesh, SEED + 7, i, dev, total, H, W),
                num_inference_steps=2, guidance_scale=7.5)
        if images.shape != (B // n, H, W, 3) or not torch.isfinite(
                images).all():
            raise AssertionError(f"phase 3: images {tuple(images.shape)}")
        return images

    saved = Path(workdir) / "images"
    _reset()
    stats = run_batches(loader, step_fn, str(saved), use_png=True,
                        what="dryrun", mesh=mesh)
    out["launches"]["3"] = _counts()
    distributed.barrier()
    files = sorted(p.name for p in (saved / "upper_body").iterdir())
    if stats["images"] != B or files != names:
        raise AssertionError(f"phase 3: {stats['images']} images, saved "
                             f"{files}")
    _log("3 (data-parallel sampling)", f"ok: {B} images, each saved by "
         f"the rank that sampled it")
    del pipe, unet, adapter, modules, optimizer, step

    # --- phase 4: data n/2 x model 2 tensor-parallel train step
    if n % 2:
        _log("4 (TP)", "skipped: an odd rank count has no model axis")
        return out
    mesh2d = make_mesh(MeshSpec(data=n // 2, model=2))
    unet, adapter, vae, text = _towers(dev, dtype)
    full_q = unet.down_blocks[1].attentions[0].transformer_blocks[0] \
        .attn1.to_q.weight.shape
    tp.unet_tp(unet, mesh2d)
    _, optimizer, step = _step_fn(mesh2d, unet, adapter, vae, text, dev,
                                  dtype)
    _reset()
    loss4 = float(step(shard_batch(mesh2d, batch),
                       _draws(mesh2d, batch, 0, dev))["loss"])
    out["launches"]["4"] = _counts()
    q = unet.down_blocks[1].attentions[0].transformer_blocks[0].attn1 \
        .to_q.weight
    if not (getattr(q, "tp_sharded", False)
            and q.shape[0] * 2 == full_q[0]):
        raise AssertionError(f"phase 4: the updated to_q weight {tuple(
            q.shape)} is not a slice of {tuple(full_q)}")
    if not torch.isfinite(torch.tensor(loss4)):
        raise AssertionError(f"phase 4: non-finite loss {loss4}")
    out["loss4"] = loss4
    _log(f"4 (data={n // 2} x model=2 TP train step)",
         f"ok: loss={loss4:.4f}, to_q {tuple(q.shape)} of {tuple(full_q)}")
    return out


class _Quiet:
    def info(self, msg: str) -> None:
        pass


def dryrun_multichip(n_ranks: int, device: str = "cuda", *,
                     timeout: float = 900.0, log_dir=None) -> list:
    """Run the four phases on ``n_ranks`` ranks over gloo (on ``device``:
    ``cuda``, where more ranks than cards share them, or ``cpu``, each
    rank on one thread); each rank's result, in rank order.  A failing or
    hung rank raises, and so does ``cuda`` where there is no card."""
    from ladi_vton_tpu_torch.core.dtypes import resolve_device
    from ladi_vton_tpu_torch.parallel.launch import spawn

    device = resolve_device(device).type
    env = {"OMP_NUM_THREADS": "1"} if device == "cpu" else {}
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        t0 = time.perf_counter()
        results = spawn("ladi_vton_tpu_torch.parallel.dryrun:run_rank",
                        n_ranks, (device, work), timeout=timeout,
                        backend="gloo", env=env, log_dir=log_dir)
    print(f"dryrun_multichip({n_ranks}) ok on {device} in "
          f"{time.perf_counter() - t0:.1f} s: losses "
          f"{[round(r['loss1'], 4) for r in results]}", flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
