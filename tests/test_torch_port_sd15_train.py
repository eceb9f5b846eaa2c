"""The port's VTO train step with the SD-1.5 family of the extended UNet
against the JAX package's, on the CPU, in both forms the JAX trainer
trains.

* ``eight-heads``: ``sd15_unet_config``'s form (``head_dim=-1``: eight
  heads of C / 8 at every width, 1x1-conv ``proj_in``/``proj_out``), as a
  sidecar's ``head_dim: -1`` gives it.
* ``diffusers``: a diffusers SD-1.5 ``unet/config.json``, whose
  ``attention_head_dim`` both zoos drop, so the heads stay 64 wide (one
  head a level here) under conv projections.

Tiny fp32 towers (``test_torch_port_train_steps.py``'s two-level UNet of
64 channels, one layer a block, with the context as wide as a one-layer
quick_gelu text tower, the SD-1.5 text tower's activation) carry the
same random parameters on both sides.  (A level of 128 channels would
make the JAX step trace its Pallas GroupNorm branch, seconds a case;
``test_torch_port_sd15_ranks.py`` has one, where the diffusers form's
two-head level splits and its one-head level stays whole.)  Held at
``test_torch_port_train_steps.py``'s tolerances (``LOSS_RTOL``,
``GRAD_RTOL``): the step's loss and every trainable gradient against the
jitted JAX ``make_vto_train_step`` in every ``VTO_CASES`` case (those
that train the adapter in ``test_torch_port_sd15_train_adapter.py``,
gradient accumulation 2 in ``test_torch_port_sd15_accumulation.py``, so
that each file stays under a minute); the UNet's gradient
checkpointing gives the same gradients, in fp32 and under bf16 autocast
with fp32 parameters; the
tensor-parallel plan of an SD-1.5 UNet is the JAX ``unet_tp_specs``
through ``unet_key_map``, the conv projections replicated, and the
attentions whose heads do not divide ``tp`` stay whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladi_vton_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from ladi_vton_tpu.models import clip as jclip
from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu.models.unet_condition import UNetConfig as JaxUNetConfig
from ladi_vton_tpu.train import steps as jsteps
from ladi_vton_tpu_torch.core import checkpoint as ckpt
from ladi_vton_tpu_torch.models import clip
from ladi_vton_tpu_torch.models.layers import Transformer2D
from ladi_vton_tpu_torch.models.unet_condition import UNet2DCondition, UNetConfig
from ladi_vton_tpu_torch.parallel import tp
from ladi_vton_tpu_torch.train import steps
from test_torch_port_tp import jax_split_axes
from test_torch_port_train_steps import (
    EMPTY,
    GRAD_RTOL,
    KEY_MAPS,
    LOSS_RTOL,
    SEQ,
    TEXT,
    VTO_CASES,
    H,
    T,
    W,
    adapter_pair,
    compare_grads,
    frozen_step,
    make_batch,
    pair,
    recorder,
    to_torch,
    vae_pair,
    vto_jax_draws,
)

torch.set_num_threads(2)
B = 2
BASE = dict(block_out_channels=(64, 64), layers_per_block=1,
            cross_attention_dim=64, use_linear_projection=False,
            down_block_has_attn=(True, False))
FORMS = {"eight-heads": dict(BASE, head_dim=-1),
         "diffusers": dict(BASE, head_dim=64)}
# the SD-1.5 text tower's activation
TEXT15 = dict(TEXT, hidden_act="quick_gelu")


def unet_pair(form: str, in_channels: int, seed: int):
    cfg = dict(FORMS[form], in_channels=in_channels)
    jm = JaxUNet(JaxUNetConfig(**cfg), attn_impl="xla")
    v, m = pair(jm, UNet2DCondition(UNetConfig(**cfg)), ckpt.unet_key_map,
                jnp.zeros((1, H // 8, W // 8, in_channels)),
                jnp.asarray([0]), jnp.zeros((1, SEQ, 64)), seed=seed)
    return jm, v, m


def text15_pair(seed: int = 12):
    jm = jclip.CLIPTextModel(jclip.CLIPTextConfig(**TEXT15))
    v, m = pair(jm, clip.CLIPTextModel(clip.CLIPTextConfig(**TEXT15)),
                ckpt.clip_text_key_map, jnp.zeros((1, SEQ), jnp.int32),
                seed=seed)
    return jm, v, m


@pytest.fixture(scope="module")
def shared():
    return {"vae": vae_pair(), "text": text15_pair(),
            "adapter": adapter_pair()}


@pytest.fixture(scope="module", params=sorted(FORMS))
def form_towers(request, shared):
    form = request.param
    seed = 60 if form == "eight-heads" else 70
    return form, {**shared, 31: unet_pair(form, 31, seed),
                  27: unet_pair(form, 27, seed + 1)}


def test_forms_have_the_heads_they_claim(form_towers):
    form, towers = form_towers
    unet = towers[31][2]
    got = sorted({(tuple(m.proj_in.weight.shape),
                   m.transformer_blocks[0].attn1.heads,
                   m.transformer_blocks[0].attn1.dim_head)
                  for m in unet.modules() if isinstance(m, Transformer2D)})
    assert got == ([((64, 64, 1, 1), 8, 8)] if form == "eight-heads"
                   else [((64, 64, 1, 1), 1, 64)])


def vto_setup(towers, text_usage, cloth, train_adapter, A=1):
    """The JAX step (jitted, its gradients recorded) and the port's loss
    over ``towers`` (``test_torch_port_train_steps.vto_setup`` with this
    file's towers)."""
    jvae, vv, vae = towers["vae"]
    jtext, tv, text = towers["text"]
    jad, av, adapter = towers["adapter"]
    jun, uv, unet = towers[31 if cloth == "warped" else 27]
    for m in (vae, text, adapter, unet):
        m.zero_grad(set_to_none=True)
        m.requires_grad_(False)
    unet.requires_grad_(True)
    adapter.requires_grad_(train_adapter)
    cfg = dict(uncond_fraction=0.5, num_vstar=2, text_usage=text_usage,
               cloth_input_type=cloth,
               train_inversion_adapter=train_adapter,
               gradient_accumulation_steps=A)
    jstep = jax.jit(jsteps.make_vto_train_step(
        unet=jun, vae=jvae, text_model=jtext, noise_scheduler=JaxDDPM(),
        config=jsteps.VTOStepConfig(**cfg), inversion_adapter=jad,
        empty_prompt_ids=jnp.asarray(EMPTY)))
    trainable, frozen = {"unet": uv}, {"vae": vv, "text": tv}
    modules = {"unet": unet}
    if train_adapter:
        trainable["adapter"] = av
        modules["adapter"] = adapter
    else:
        frozen["adapter"] = av
    state = jsteps.TrainState.create(trainable, recorder())
    loss_fn = steps.make_vto_loss(
        unet=unet, vae=vae, text_model=text,
        config=steps.VTOStepConfig(**cfg), inversion_adapter=adapter,
        empty_prompt_ids=T(EMPTY).long())
    return jstep, state, frozen, modules, loss_fn


def check_vto_step(form_towers, case: str) -> None:
    """The port's step against the JAX step in a ``VTO_CASES`` case at
    A = 1, or (``"accumulation-2"``) with the adapter trained on the
    warped cloth at A = 2 (micro-batch i draws from ``split(rng, A)[i]``,
    as the JAX scan does; ``test_torch_port_sd15_accumulation.py`` runs
    it)."""
    _, towers = form_towers
    A = 2 if case == "accumulation-2" else 1
    text_usage, cloth, train_adapter = VTO_CASES.get(
        case, ("inversion_adapter", "warped", True))
    jstep, state, frozen, modules, loss_fn = vto_setup(
        towers, text_usage, cloth, train_adapter, A)
    batch = make_batch(80 + A, n=B * A,
                       vstar=text_usage == "inversion_adapter")
    rng = jax.random.key(81)
    new_state, metrics = jstep(state, frozen, jax.tree_util.tree_map(
        jnp.asarray, batch), rng)
    parts = [vto_jax_draws(r, B)
             for r in (jax.random.split(rng, A) if A > 1 else [rng])]
    draws = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    assert 0 < int((draws["uncond"] < 0.5).sum()) < 3 * B * A
    ours = frozen_step(modules, loss_fn, A)(to_torch(batch), draws)
    ref = float(metrics["loss"])
    assert abs(float(ours["loss"]) - ref) <= LOSS_RTOL * abs(ref)
    compare_grads(modules, new_state.opt_state, KEY_MAPS, rtol=GRAD_RTOL)


# the cases with the adapter frozen; those that train it run in
# test_torch_port_sd15_train_adapter.py, so that each file stays under a
# minute
FROZEN_ADAPTER_CASES = sorted(c for c, v in VTO_CASES.items() if not v[2])


@pytest.mark.parametrize("case", FROZEN_ADAPTER_CASES)
def test_sd15_vto_step_matches_jax(form_towers, case):
    check_vto_step(form_towers, case)


@pytest.mark.parametrize("precision", ["fp32", "bf16-autocast"])
def test_sd15_gradient_checkpointing_gives_the_same_gradients(form_towers,
                                                               precision):
    """Checkpointed blocks recompute the conv projections and the
    attentions in the backward: the gradients of the fp32 parameters are
    the plain ones (bf16 autocast on the CPU too, as the trainers run it
    on the card)."""
    _, towers = form_towers
    unet = towers[27][2]
    unet.requires_grad_(True)
    rng = np.random.default_rng(82)
    x = T(rng.standard_normal((2, 27, H // 8, W // 8)).astype(np.float32))
    ctx = T(rng.standard_normal((2, SEQ, 64)).astype(np.float32))
    t = torch.tensor([3, 500])
    cast = (torch.autocast("cpu", dtype=torch.bfloat16)
            if precision == "bf16-autocast" else torch.autocast(
                "cpu", enabled=False))
    grads = []
    try:
        for on in (False, True):
            unet.zero_grad(set_to_none=True)
            unet.gradient_checkpointing = on
            with cast:
                out = unet(x, t, ctx)
            out.float().square().mean().backward()
            grads.append({k: p.grad.clone()
                          for k, p in unet.named_parameters()})
    finally:
        unet.gradient_checkpointing = False
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads[1].values())
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-5, atol=1e-7,
                                   msg=k)


def test_sd15_plan_covers_the_jax_plan(form_towers):
    """The leaves the port splits are those the JAX plan shards, along the
    same axes; the conv projections are not among them."""
    _, towers = form_towers
    _, variables, unet = towers[31]
    specs = tp.unet_tp_specs(unet.state_dict())
    ours = {k: s[1] for k, s in specs.items() if s is not None}
    assert ours == jax_split_axes(variables)
    assert all(specs[k] is None for k in specs
               if ".proj_in." in k or ".proj_out." in k)


@pytest.mark.parametrize("n", [2, 4])
def test_sd15_plan_keeps_indivisible_heads_whole(form_towers, n):
    """At ``tp`` ranks every attention whose heads ``tp`` divides is split
    (the eight-head form's at 2 and 4), the others stay whole on every
    rank (the diffusers form's one head a level); the feed-forwards split
    at every level; sharding a state dict and gathering it back is
    bitwise the identity."""
    form, towers = form_towers
    unet = towers[31][2]
    plan = tp.unet_tp_plan(unet, n)
    split = {s is not None for k, s in plan.items() if ".to_q." in k}
    assert split == {form == "eight-heads"}
    assert all(s is not None for k, s in plan.items()
               if ".ff.net.0.proj." in k)
    sd = unet.state_dict()
    shards = [tp.tp_shard_state_dict(sd, r, n, plan) for r in range(n)]
    back = tp.tp_gather_state_dict(shards, plan)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)

