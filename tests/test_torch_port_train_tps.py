"""The port's warping (TPS, refinement) and inversion-adapter train steps
against the JAX package's, on the CPU.

The same random parameters and BatchNorm statistics on both sides
(``state_dict_from_jax``); each JAX step runs jitted with an optax
transformation that records the gradients.  Phase A: TPS at 128x96 in
train mode; phase B: the refinement at 64x48 behind a frozen TPS at
256x192, with the VGG loss.  The cloth is smooth, as a garment is: the
gradient of bilinear sampling with respect to the grid jumps where a
coordinate crosses a pixel, so on a white-noise cloth the last-bit
differences of the two TPS solves (float64 here, fp32 at HIGHEST
precision there) move whole gradients; for the same reason phase A's
target stays off the L1 loss's kink.  Held for each: the loss within
1e-5 relative (the TPS's L1 and regularisers within 1e-4, the tolerance
of the regularisers in ``test_torch_port_condition.py``), every trained
parameter's gradient within 1e-4 relative L2 (phase A's within 2e-3 and
phase B's within 3e-2, for the reasons stated at ``TPS_GRAD_RTOL`` and
``REFINEMENT_GRAD_RTOL``), and the BatchNorm running statistics after the step against flax's
``batch_stats`` (momentum 0.9, the biased batch variance) within 1e-5.
The adapter step (the frozen 9-channel UNet, the JAX draws of
``split(rng, 4)`` handed to the port): loss and gradients as above.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict

from ladi_vton_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from ladi_vton_tpu.models import tps as jtps
from ladi_vton_tpu.models.refinement import UNetVanilla as JaxUNetVanilla
from ladi_vton_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from ladi_vton_tpu.train import steps as jsteps
from ladi_vton_tpu.train import tps_steps as jtps_steps
from ladi_vton_tpu_torch.core import checkpoint as ckpt
from ladi_vton_tpu_torch.models import tps
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.ops.grid_sample import grid_sample
from ladi_vton_tpu_torch.train import tps_steps
from test_torch_port_condition import random_variables
from test_torch_port_train_emasc import vgg_pair
from test_torch_port_train_steps import (
    LOSS_RTOL,
    B,
    H,
    W,
    adapter_pair,
    compare_grads,
    frozen_step,
    make_batch,
    nchw,
    recorder,
    rel_l2,
    text_pair,
    to_torch,
    unet_pair,
    vae_pair,
)

torch.set_num_threads(2)
T = torch.from_numpy
STATS_RTOL = 1e-5
# phase A's gradients reach TPS through its warp grid, whose two solves
# (float64 here, fp32 at HIGHEST precision there) differ by up to 1.2e-5;
# bilinear sampling's gradient jumps where a coordinate crosses a pixel,
# so grids that close still move ~5e-4 of the gradient (measured up to
# 7e-4 on this case): 2e-3.  The two sides' sampling gradients at one grid,
# and the solve's own gradient, are held at 1e-5 below.
TPS_GRAD_RTOL = 2e-3
# the refinement's gradient runs back through 18 train-mode BatchNorms in
# fp32, whose batch-mean subtraction cancels: at one input, each package's
# fp32 gradient lies up to 3.3e-3 from a float64 run of the port's
# refinement (measured), and the step's two sides differ by up to 1.0%
# (measured on this case): 3e-2
REFINEMENT_GRAD_RTOL = 3e-2


def bn_pair(jmodel, module, key_map, *init_args, seed):
    variables, flat = random_variables(jmodel, *init_args, seed=seed)
    module.load_state_dict(ckpt.state_dict_from_jax(flat, key_map),
                           strict=True)
    return variables, module


def smooth(rng, h: int, w: int) -> np.ndarray:
    """A smooth garment-like image in [-1, 1]: a few low-frequency waves
    of random direction and phase per channel."""
    y, x = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    out = np.zeros((B, h, w, 3))
    for b in range(B):
        for c in range(3):
            for _ in range(3):
                fy, fx = rng.uniform(-3, 3, 2)
                phase = rng.uniform(0, 2 * np.pi)
                out[b, :, :, c] += np.sin(2 * np.pi * (fy * y + fx * x)
                                          + phase) / 3
    return out.astype(np.float32)


def warp_batch(seed: int, h: int, w: int, target=(-1.0, 1.0)) -> dict:
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"cloth": smooth(rng, h, w),
            "im_cloth": rng.uniform(*target, (B, h, w, 3)).astype(f),
            "im_mask": rng.uniform(-1, 1, (B, h, w, 3)).astype(f),
            "pose": rng.uniform(0, 1, (B, h, w, 18)).astype(f)}


def bias_before_batch_norm(key: str) -> bool:
    """The regression's conv biases (Sequential indices 0, 3, 6, 9): the
    train-mode BatchNorm after each conv subtracts the batch mean, so their
    gradient is 0 but for rounding."""
    return re.fullmatch(r"loc_net\.regression\.conv\.[0369]\.bias",
                        key) is not None


def check_stats(module, batch_stats, key_map) -> None:
    """The module's running statistics against flax's batch_stats."""
    ref = ckpt.state_dict_from_jax(flatten_dict(
        {"batch_stats": batch_stats}), key_map)
    ours = module.state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        assert rel_l2(ours[key].numpy(), ref[key].numpy()) < STATS_RTOL, key
    for key in [k for k in ours if k.endswith("num_batches_tracked")]:
        assert int(ours[key]) == 1, key


def check_metrics(ours: dict, ref: dict, keys, rtol=LOSS_RTOL) -> None:
    for key in keys:
        r = float(ref[key])
        assert abs(float(ours[key]) - r) <= rtol * abs(r), key


def test_tps_step_matches_jax():
    TH, TW = 128, 96
    jm = jtps.ConvNetTPS(height=TH, width=TW, input_nc_b=21)
    variables, module = bn_pair(jm, tps.ConvNetTPS(TH, TW, 21),
                                ckpt.tps_key_map, jnp.zeros((1, TH, TW, 3)),
                                jnp.zeros((1, TH, TW, 21)), seed=60)
    jstep = jax.jit(jtps_steps.make_tps_train_step(tps=jm))
    state = jtps_steps.MutableTrainState.create(variables, recorder())
    # the target lies above the cloth's range: no pixel of |warped -
    # target| sits at the L1 kink, where the grids' last-bit differences
    # (a float64 TPS solve here, fp32 there) would flip its gradient
    batch = warp_batch(61, TH, TW, target=(1.5, 2.5))
    new_state, metrics = jstep(state, jax.tree_util.tree_map(jnp.asarray,
                                                             batch))
    ours = frozen_step({"tps": module}, tps_steps.make_tps_loss(
        tps=module))(to_torch(batch))
    assert module.training
    check_metrics(ours, metrics, ("loss",))
    # the six regularisers difference squared differences of the control
    # points, held at 1e-4 as test_torch_port_condition.py holds them
    check_metrics(ours, metrics, ("l1", "const"), rtol=1e-4)
    compare_grads({"tps": module}, {"tps": new_state.opt_state},
                  {"tps": ckpt.tps_key_map}, zero=bias_before_batch_norm,
                  rtol=TPS_GRAD_RTOL)
    check_stats(module, new_state.extra["batch_stats"], ckpt.tps_key_map)


def test_tps_grid_gradients_match_jax_and_float64():
    """At one grid, the two grid samples' gradients agree; the port's TPS
    solve differentiates as its float64 closed form."""
    TH, TW = 128, 96
    rng = np.random.default_rng(67)
    b = warp_batch(68, TH, TW, target=(1.5, 2.5))
    grid = rng.uniform(-1.1, 1.1, (B, TH, TW, 2)).astype(np.float32)

    def jax_l1(g):
        warped = jax_grid_sample(jnp.asarray(b["cloth"]), g,
                                 padding_mode="border")
        return jnp.mean(jnp.abs(warped - jnp.asarray(b["im_cloth"])))

    ref = np.asarray(jax.grad(jax_l1)(jnp.asarray(grid)))
    g = T(grid).requires_grad_(True)
    warped = grid_sample(T(b["cloth"]), g, padding_mode="border")
    (warped - T(b["im_cloth"])).abs().mean().backward()
    assert rel_l2(g.grad.numpy(), ref) < 1e-5
    # d grid / d control points: coord_repr @ inverse_kernel[:, :N]
    gen = tps.TPSGridGen(TH, TW)
    cp = T(rng.uniform(-1, 1, (B, 25, 2)).astype(np.float32))
    cp.requires_grad_(True)
    cot = rng.standard_normal((B, TH, TW, 2))
    (gen(cp) * T(cot.astype(np.float32))).sum().backward()
    K = gen.inverse_kernel.double().numpy()
    R = gen.coord_repr.double().numpy()
    exact = np.einsum("ij,pi,bpk->bjk", K, R, cot.reshape(B, -1, 2))[:, :25]
    assert rel_l2(cp.grad.numpy(), exact) < 1e-5


def test_refinement_step_matches_jax():
    RH, RW = 64, 48
    jt = jtps.ConvNetTPS(height=256, width=192, input_nc_b=21)
    tv, tmodule = bn_pair(jt, tps.ConvNetTPS(256, 192, 21), ckpt.tps_key_map,
                          jnp.zeros((1, 256, 192, 3)),
                          jnp.zeros((1, 256, 192, 21)), seed=62)
    jr = JaxUNetVanilla()
    rv, rmodule = bn_pair(jr, UNetVanilla(), ckpt.refinement_key_map,
                          jnp.zeros((1, RH, RW, 24)), seed=63)
    jvgg, vggv, vgg = vgg_pair()
    tmodule.requires_grad_(False)
    jstep = jax.jit(jtps_steps.make_refinement_train_step(
        tps=jt, refinement=jr, vgg=jvgg, height=RH, width=RW))
    state = jtps_steps.MutableTrainState.create(rv, recorder())
    batch = warp_batch(64, RH, RW)
    new_state, metrics = jstep(state, {"tps": tv, "vgg": vggv},
                               jax.tree_util.tree_map(jnp.asarray, batch))
    tps_stats = {k: v.clone() for k, v in tmodule.state_dict().items()}
    ours = frozen_step({"refinement": rmodule}, tps_steps.make_refinement_loss(
        tps=tmodule, refinement=rmodule, vgg=vgg, height=RH, width=RW))(
            to_torch(batch))
    check_metrics(ours, metrics, ("loss", "l1", "vgg"))
    compare_grads({"refinement": rmodule}, {"refinement": new_state.opt_state},
                  {"refinement": ckpt.refinement_key_map},
                  rtol=REFINEMENT_GRAD_RTOL)
    check_stats(rmodule, new_state.extra["batch_stats"],
                ckpt.refinement_key_map)
    # the frozen TPS ran in eval mode: its statistics did not move
    assert not tmodule.training
    for key, value in tmodule.state_dict().items():
        assert torch.equal(value, tps_stats[key]), key


def test_inversion_adapter_step_matches_jax():
    jvae, vv, vae = vae_pair()
    jtext, tv, text = text_pair()
    jad, av, adapter = adapter_pair()
    jun, uv, unet = unet_pair(9, 16)
    for m in (vae, text, unet):
        m.requires_grad_(False)
    adapter.requires_grad_(True)
    jstep = jax.jit(jtps_steps.make_inversion_adapter_train_step(
        unet9=jun, vae=jvae, text_model=jtext, inversion_adapter=jad,
        noise_scheduler=JaxDDPM(), num_vstar=2))
    state = jsteps.TrainState.create({"adapter": av}, recorder())
    batch = make_batch(65)
    keys = ("image", "im_mask", "inpaint_mask", "input_ids",
            "clip_cloth_features")
    batch = {k: batch[k] for k in keys}
    rng = jax.random.key(66)
    new_state, metrics = jstep(state, {"vae": vv, "text": tv, "unet": uv},
                               jax.tree_util.tree_map(jnp.asarray, batch),
                               rng)
    r = jax.random.split(rng, 4)
    shape = (B, H // 8, W // 8, 4)
    draws = {"latents": nchw(jax.random.normal(r[0], shape)),
             "noise": nchw(jax.random.normal(r[1], shape)),
             "timesteps": T(np.array(jax.random.randint(r[2], (B,), 0,
                                                        1000))).long(),
             "masked": nchw(jax.random.normal(r[3], shape))}
    loss_fn = tps_steps.make_inversion_adapter_loss(
        unet9=unet, vae=vae, text_model=text, inversion_adapter=adapter,
        num_vstar=2)
    ours = frozen_step({"adapter": adapter}, loss_fn)(to_torch(batch), draws)
    check_metrics(ours, metrics, ("loss",))
    compare_grads({"adapter": adapter}, new_state.opt_state,
                  {"adapter": ckpt.inversion_adapter_key_map})
