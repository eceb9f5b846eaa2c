"""The port's VGG loss and EMASC train step against the JAX package's, on
the CPU.

The same random parameters on both sides (``state_dict_from_jax``): a
VGG19 (the JAX tower's convs 0..28; the port's three convs past the last
tap keep their own values, which no output reads), a four-level VAE of
one layer a block and the EMASC of its channel plan, linear and
nonlinear.  VGG: the preprocessing, the five tapped features and their
VJP, and ``vgg_loss``, within 1e-5 relative L2.  EMASC: the JAX step, jitted, with an
optax transformation that records the gradients, and its posterior draw
(``normal(rng)``) handed to the port's loss; the loss within 1e-5
relative, every EMASC parameter's gradient within 1e-4 relative L2 (fp32,
sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladi_vton_tpu.models.emasc import EMASC as JaxEMASC
from ladi_vton_tpu.models.emasc import emasc_channels as jax_emasc_channels
from ladi_vton_tpu.models.vgg import VGG19Features as JaxVGG
from ladi_vton_tpu.models.vgg import vgg_loss as jax_vgg_loss
from ladi_vton_tpu.models.vgg import vgg_preprocess as jax_vgg_preprocess
from ladi_vton_tpu.train import steps as jsteps
from ladi_vton_tpu_torch.core import checkpoint as ckpt
from ladi_vton_tpu_torch.models.emasc import EMASC, emasc_channels
from ladi_vton_tpu_torch.models.vgg import (
    VGG19Features,
    vgg_loss,
    vgg_preprocess,
)
from ladi_vton_tpu_torch.train import steps
from test_torch_port_condition import random_variables
from test_torch_port_train_steps import (
    LOSS_RTOL,
    compare_grads,
    frozen_step,
    make_batch,
    nchw,
    pair,
    recorder,
    rel_l2,
    to_torch,
    vae_pair,
)

torch.set_num_threads(2)
T = torch.from_numpy
H = W = 64


def vgg_pair(seed: int = 40):
    jm = JaxVGG()
    variables, flat = random_variables(jm, jnp.zeros((1, 32, 32, 3)),
                                       seed=seed)
    vgg = VGG19Features()
    state = vgg.state_dict()
    ours = ckpt.state_dict_from_jax(
        flat, lambda k: k.replace("conv.", "features.", 1))
    assert set(ours) <= set(state)
    state.update(ours)
    vgg.load_state_dict(state, strict=True)
    return jm, variables, vgg.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def vgg():
    return vgg_pair()


def test_vgg_features_and_loss_match_jax(vgg):
    jm, variables, tower = vgg
    rng = np.random.default_rng(41)
    pred = rng.uniform(-1, 1, (2, 48, 40, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, 48, 40, 3)).astype(np.float32)
    # short side 256: (48, 40) -> (307, 256), as the reference's Resize
    x = vgg_preprocess(nchw(pred))
    assert x.shape == (2, 3, 307, 256)
    ref_x = np.asarray(jax_vgg_preprocess(jnp.asarray(pred)))
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), ref_x,
                               rtol=1e-5, atol=1e-5)
    # the features and their VJP for random cotangents, on a random input
    # (an upsampled image holds near-ties that the max pools route by
    # rounding)
    ref_x = rng.standard_normal((2, 64, 48, 3)).astype(np.float32)
    xt = nchw(ref_x).requires_grad_(True)
    feats = tower(xt)
    ref_feats, vjp = jax.vjp(lambda a: jm.apply(variables, a),
                             jnp.asarray(ref_x))
    assert len(feats) == len(ref_feats) == 5
    cot = [rng.standard_normal(f.shape).astype(np.float32)
           for f in ref_feats]
    for ours, ref in zip(feats, ref_feats):
        assert rel_l2(ours.detach().permute(0, 2, 3, 1).numpy(), ref) < 1e-5
    torch.autograd.backward(feats, [nchw(c) for c in cot])
    (ref_grad,) = vjp([jnp.asarray(c) for c in cot])
    assert rel_l2(xt.grad.permute(0, 2, 3, 1).numpy(), ref_grad) < 1e-5
    # the loss (its gradient sits on |a - b| kinks, where rounding-level
    # differences flip a sign: the EMASC step holds it through the tower's
    # parameters instead)
    ref_loss = float(jax_vgg_loss(jm, variables, jnp.asarray(pred),
                                  jnp.asarray(target)))
    loss = float(vgg_loss(tower, nchw(pred), nchw(target)))
    assert abs(loss - ref_loss) <= 1e-5 * ref_loss


@pytest.mark.parametrize("kind", ["linear", "nonlinear"])
def test_emasc_step_matches_jax(vgg, kind):
    jvgg, vggv, tower = vgg
    jvae, vv, vae = vae_pair()
    vae.requires_grad_(False)
    assert emasc_channels(vae.config) == jax_emasc_channels(jvae.config)
    in_ch, out_ch = emasc_channels(vae.config)
    jm = JaxEMASC(in_channels=in_ch, out_channels=out_ch, kind=kind)
    ev, emasc = pair(jm, EMASC(in_ch, out_ch, kind=kind),
                     ckpt.emasc_key_map(kind),
                     [jnp.zeros((1, 8, 8, c)) for c in in_ch], seed=42)
    jstep = jax.jit(jsteps.make_emasc_train_step(vae=jvae, emasc=jm,
                                                 vgg=jvgg, vgg_weight=0.5))
    state = jsteps.TrainState.create({"emasc": ev}, recorder())
    batch = make_batch(43)
    batch = {k: batch[k] for k in ("image", "im_mask", "inpaint_mask")}
    rng = jax.random.key(44)
    new_state, metrics = jstep(state, {"vae": vv, "vgg": vggv},
                               jax.tree_util.tree_map(jnp.asarray, batch),
                               rng)
    draws = {"latents": nchw(jax.random.normal(rng, (2, H // 8, W // 8,
                                                     4)))}
    loss_fn = steps.make_emasc_loss(vae=vae, emasc=emasc, vgg=tower,
                                    vgg_weight=0.5)
    ours = frozen_step({"emasc": emasc}, loss_fn)(to_torch(batch), draws)
    for key in ("loss", "l1", "vgg"):
        ref = float(metrics[key])
        assert abs(float(ours[key]) - ref) <= LOSS_RTOL * abs(ref), key
    compare_grads({"emasc": emasc}, new_state.opt_state,
                  {"emasc": ckpt.emasc_key_map(kind)})
