"""The port's extended-UNet train step and optimizer against the JAX
package's, on the CPU.

Tiny fp32 towers (a two-level UNet of one layer a block, 64 channels
wide so that its 32-group norms hold two channels a group and no bias
gradient vanishes, a four-level VAE of one layer a block, a one-layer
CLIP text encoder and adapter) carry the same random parameters on both
sides (``state_dict_from_jax``).  The JAX step runs jitted with an optax
transformation that records the gradients instead of applying them; its
draws (``jax.random.split(rng, 6)``: the three posterior noises, the
diffusion noise, the timesteps, the dropout uniforms) are reproduced
and handed to the port's loss, which takes them as an argument.  The
port's step runs with a learning rate of 0 and no clip, so its
parameters' ``.grad`` are the step's gradients.  Held: the loss within
1e-5 relative, every trainable parameter's gradient within 1e-4 relative
L2 (fp32 towers, sums in other orders), under ``text_usage``
inversion_adapter and noun_chunks, ``cloth_input_type`` warped and none,
the adapter trained and frozen; gradient accumulation (A = 2) against the
JAX accumulating step.  The optimizer alone: one gradient sequence
through the port's AdamW + clip and through optax, five updates, all six
schedules, parameters within 1e-6.  The UNet's gradient checkpointing
gives the plain gradients.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from ladi_vton_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from ladi_vton_tpu.models import clip as jclip
from ladi_vton_tpu.models.inversion_adapter import InversionAdapter as JaxAdapter
from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu.models.unet_condition import UNetConfig as JaxUNetConfig
from ladi_vton_tpu.models.vae import AutoencoderKL as JaxVAE
from ladi_vton_tpu.models.vae import VAEConfig as JaxVAEConfig
from ladi_vton_tpu.train import steps as jsteps
from ladi_vton_tpu_torch.core import checkpoint as ckpt
from ladi_vton_tpu_torch.models import clip
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.unet_condition import UNet2DCondition, UNetConfig
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ladi_vton_tpu_torch.train import steps
from test_torch_port_condition import random_variables

torch.set_num_threads(2)
T = torch.from_numpy
H = W = 64
B = 2
SEQ = 16
NUM_VSTAR = 2
UNET = dict(block_out_channels=(64, 64), layers_per_block=1, head_dim=8,
            cross_attention_dim=64, down_block_has_attn=(True, False))
VAE = dict(block_out_channels=(32, 32, 32, 32), layers_per_block=1)
TEXT = dict(vocab_size=300, hidden_size=64, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=SEQ)
VISION = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
              intermediate_size=32)
ADAPTER = dict(input_dim=16, hidden_dim=32, output_dim=64 * NUM_VSTAR,
               num_encoder_layers=1)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def rel_l2(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref),
                                                  1e-30))


def pair(jmodel, torch_module, key_map, *init_args, seed):
    variables, flat = random_variables(jmodel, *init_args, seed=seed)
    torch_module.load_state_dict(ckpt.state_dict_from_jax(flat, key_map),
                                 strict=True)
    return variables, torch_module.eval()


def unet_pair(in_channels: int, seed: int):
    jm = JaxUNet(JaxUNetConfig(in_channels=in_channels, **UNET),
                 attn_impl="xla")
    v, m = pair(jm, UNet2DCondition(UNetConfig(in_channels=in_channels,
                                               **UNET)), ckpt.unet_key_map,
                jnp.zeros((1, H // 8, W // 8, in_channels)),
                jnp.asarray([0]), jnp.zeros((1, SEQ, 64)), seed=seed)
    return jm, v, m


def vae_pair(seed: int = 11):
    jm = JaxVAE(JaxVAEConfig(**VAE))
    v, m = pair(jm, AutoencoderKL(VAEConfig(**VAE)), None,
                jnp.zeros((1, H, W, 3)), seed=seed)
    return jm, v, m


def text_pair(seed: int = 12):
    jcfg = jclip.CLIPTextConfig(**TEXT)
    jm = jclip.CLIPTextModel(jcfg)
    v, m = pair(jm, clip.CLIPTextModel(clip.CLIPTextConfig(**TEXT)),
                ckpt.clip_text_key_map, jnp.zeros((1, SEQ), jnp.int32),
                seed=seed)
    return jm, v, m


def adapter_pair(seed: int = 13):
    jm = JaxAdapter(vision_config=jclip.CLIPVisionConfig(**VISION), **ADAPTER)
    v, m = pair(jm, InversionAdapter(
        vision_config=clip.CLIPVisionConfig(**VISION), **ADAPTER),
        ckpt.inversion_adapter_key_map, jnp.zeros((1, 5, 16)), seed=seed)
    return jm, v, m


@pytest.fixture(scope="module")
def towers():
    return {"vae": vae_pair(), "text": text_pair(), "adapter": adapter_pair(),
            31: unet_pair(31, 14), 27: unet_pair(27, 15)}


def ids(rng, n: int, vstar: bool) -> np.ndarray:
    """CLIP-style ids: start 298, words, a '$' run, end 299, padding 0."""
    out = np.zeros((n, SEQ), np.int32)
    for i in range(n):
        words = list(rng.integers(1, 259, 4)) + [259] * (NUM_VSTAR * vstar)
        out[i, :len(words) + 2] = [298, *words, 299]
    return out


def make_batch(seed: int, n: int = B, vstar: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    f = np.float32
    mask = np.zeros((n, H, W, 1), f)
    mask[:, 16:56, 12:52] = 1.0
    image = rng.uniform(-1, 1, (n, H, W, 3)).astype(f)
    return {"image": image, "im_mask": image * (1 - mask),
            "inpaint_mask": mask,
            "pose_map": rng.uniform(0, 1, (n, H, W, 18)).astype(f),
            "warped_cloth": rng.uniform(-1, 1, (n, H, W, 3)).astype(f),
            "input_ids": ids(rng, n, vstar),
            "clip_cloth_features": rng.standard_normal((n, 5, 16)).astype(f)}


EMPTY = np.asarray([298, 299] + [0] * (SEQ - 2), np.int32)


def recorder() -> optax.GradientTransformation:
    """An optax transformation whose state becomes the gradients, the
    parameters unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def to_torch(batch: dict) -> dict:
    return {k: T(np.ascontiguousarray(v)).long() if k == "input_ids"
            else T(np.ascontiguousarray(v)) for k, v in batch.items()}


def nchw(x) -> torch.Tensor:
    return T(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def vto_jax_draws(rng, n: int) -> dict:
    """The draws of the JAX VTO loss for ``rng``, in the port's layout."""
    r = jax.random.split(rng, 6)
    shape = (n, H // 8, W // 8, 4)
    return {"latents": nchw(jax.random.normal(r[0], shape)),
            "noise": nchw(jax.random.normal(r[1], shape)),
            "timesteps": T(np.array(jax.random.randint(r[2], (n,), 0,
                                                        1000))).long(),
            "masked": nchw(jax.random.normal(r[3], shape)),
            "cloth": nchw(jax.random.normal(r[4], shape)),
            "uncond": T(np.ascontiguousarray(np.asarray(
                jax.random.uniform(r[5], (3, n))).T))}


def frozen_step(modules: dict, loss_fn, A: int = 1):
    """The port's step with lr 0 and no clip: ``p.grad`` stays the step's
    gradient."""
    params = [p for m in modules.values() for p in m.parameters()]
    opt = steps.Optimizer(params, lambda count: 0.0)
    return steps.build_train_step(loss_fn, opt, A)


def zero_in_exact_arithmetic(key: str) -> bool:
    """An attention's key bias adds q.b to every logit of a query's row,
    which the softmax ignores: its gradient is 0 but for rounding."""
    return key.endswith("k_proj.bias")


def compare_grads(modules: dict, jax_grads: dict, key_maps: dict,
                  zero=zero_in_exact_arithmetic, rtol=GRAD_RTOL) -> None:
    """Every parameter's gradient within ``rtol`` relative L2; one that is
    0 in exact arithmetic (``zero(key)``) below 1e-6 of its tower's
    gradient norm on both sides."""
    for name, module in modules.items():
        ref = ckpt.state_dict_from_jax(flatten_dict(jax_grads[name]),
                                       key_maps[name])
        got = dict(module.named_parameters())
        assert sorted(got) == sorted(ref), name
        norm = np.sqrt(sum(float(v.double().square().sum())
                           for v in ref.values()))
        for key, p in got.items():
            if zero(key):
                for g in (p.grad, ref[key]):
                    assert float(g.norm()) < 1e-6 * norm, (name, key)
                continue
            err = rel_l2(p.grad.numpy(), ref[key].numpy())
            assert err < rtol, (name, key, err)


# each value of text_usage, cloth_input_type and the adapter's training
VTO_CASES = {
    "adapter-frozen": ("inversion_adapter", "warped", False),
    "adapter-trained-no-cloth": ("inversion_adapter", "none", True),
    "noun_chunks": ("noun_chunks", "warped", False),
}


def vto_setup(towers, text_usage, cloth, train_adapter, A=1):
    jvae, vv, vae = towers["vae"]
    jtext, tv, text = towers["text"]
    jad, av, adapter = towers["adapter"]
    jun, uv, unet = towers[31 if cloth == "warped" else 27]
    for m in (vae, text, adapter, unet):
        m.zero_grad(set_to_none=True)
        m.requires_grad_(False)
    unet.requires_grad_(True)
    adapter.requires_grad_(train_adapter)
    cfg = dict(uncond_fraction=0.5, num_vstar=NUM_VSTAR,
               text_usage=text_usage, cloth_input_type=cloth,
               train_inversion_adapter=train_adapter,
               gradient_accumulation_steps=A)
    jstep = jax.jit(jsteps.make_vto_train_step(
        unet=jun, vae=jvae, text_model=jtext, noise_scheduler=JaxDDPM(),
        config=jsteps.VTOStepConfig(**cfg), inversion_adapter=jad,
        empty_prompt_ids=jnp.asarray(EMPTY)))
    trainable = {"unet": uv}
    frozen = {"vae": vv, "text": tv}
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


KEY_MAPS = {"unet": ckpt.unet_key_map,
            "adapter": ckpt.inversion_adapter_key_map}


@pytest.mark.parametrize("case", sorted(VTO_CASES))
def test_vto_step_matches_jax(towers, case):
    text_usage, cloth, train_adapter = VTO_CASES[case]
    jstep, state, frozen, modules, loss_fn = vto_setup(
        towers, text_usage, cloth, train_adapter)
    batch = make_batch(20, vstar=text_usage == "inversion_adapter")
    rng = jax.random.key(21)
    new_state, metrics = jstep(state, frozen, jax.tree_util.tree_map(
        jnp.asarray, batch), rng)
    draws = vto_jax_draws(rng, B)
    # the draws drop something (uniforms under 0.5) and keep something
    assert 0 < int((draws["uncond"] < 0.5).sum()) < 3 * B
    ours = frozen_step(modules, loss_fn)(to_torch(batch), draws)
    ref = float(metrics["loss"])
    assert abs(float(ours["loss"]) - ref) <= LOSS_RTOL * abs(ref)
    compare_grads(modules, new_state.opt_state, KEY_MAPS)


def test_vto_accumulating_step_matches_jax(towers):
    A = 2
    jstep, state, frozen, modules, loss_fn = vto_setup(
        towers, "inversion_adapter", "warped", True, A=A)
    batch = make_batch(22, n=2 * A)
    rng = jax.random.key(23)
    new_state, metrics = jstep(state, frozen, jax.tree_util.tree_map(
        jnp.asarray, batch), rng)
    # micro-batch i draws from split(rng, A)[i], as the JAX scan does
    parts = [vto_jax_draws(r, 2) for r in jax.random.split(rng, A)]
    draws = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    ours = frozen_step(modules, loss_fn, A)(to_torch(batch), draws)
    ref = float(metrics["loss"])
    assert abs(float(ours["loss"]) - ref) <= LOSS_RTOL * abs(ref)
    compare_grads(modules, new_state.opt_state, KEY_MAPS)


def test_gradient_checkpointing_gives_the_same_gradients(towers):
    _, _, unet = towers[27]
    unet.requires_grad_(True)
    rng = np.random.default_rng(24)
    x = T(rng.standard_normal((2, 27, H // 8, W // 8)).astype(np.float32))
    ctx = T(rng.standard_normal((2, SEQ, 64)).astype(np.float32))
    t = torch.tensor([3, 500])
    grads = []
    for ckpt_on in (False, True):
        unet.zero_grad(set_to_none=True)
        unet.gradient_checkpointing = ckpt_on
        unet(x, t, ctx).square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in unet.named_parameters()})
    unet.gradient_checkpointing = False
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("schedule", steps.LR_SCHEDULERS)
def test_optimizer_matches_optax(schedule):
    rng = np.random.default_rng(30)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # gradients whose global norm is above the clip at some updates and
    # below it at others
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32)
              for s in shapes] for scale in (0.05, 1.0, 0.02, 2.0, 0.1)]
    kw = dict(warmup_steps=2, lr_scheduler=schedule, total_steps=5)
    tx = jsteps.make_optimizer(1e-2, weight_decay=1e-2, max_grad_norm=1.0,
                               **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(T(p.copy())) for p in params]
    opt = steps.make_optimizer(tp, 1e-2, weight_decay=1e-2,
                               max_grad_norm=1.0, **kw)
    lrs = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p, x in zip(tp, g):
            p.grad = T(x.copy())
        lrs.append(opt.schedule(opt.count))
        opt.step()
        for ours, ref in zip(tp, jp):
            np.testing.assert_allclose(ours.detach().numpy(),
                                       np.asarray(ref), rtol=1e-6, atol=1e-6)
    # optax evaluates the schedule at the count before the increment: the
    # first warmup update has lr 0
    assert opt.count == 5
    assert lrs[0] == (1e-2 if schedule == "constant" else 0.0)
    jax_lr = jsteps.make_lr_schedule(schedule, 1e-2, 2, 5)
    for count, lr in enumerate(lrs):
        ref = float(jax_lr(count)) if callable(jax_lr) else jax_lr
        assert lr == pytest.approx(ref, rel=1e-6, abs=1e-12), count


def test_optimizer_state_round_trips(tmp_path):
    p = torch.nn.Parameter(torch.ones(3))
    opt = steps.make_optimizer([p], 1e-2, warmup_steps=0)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    path = tmp_path / "opt.pt"
    torch.save(opt.state_dict(), path)
    q = torch.nn.Parameter(p.detach().clone())
    again = steps.make_optimizer([q], 1e-2, warmup_steps=0)
    again.load_state_dict(torch.load(path, weights_only=True))
    assert again.count == 1
    for param in (p, q):
        param.grad = torch.full((3,), -0.25)
    opt.step()
    again.step()
    torch.testing.assert_close(q, p, rtol=0, atol=0)
