"""The SD-1.5 family of the extended UNet over gloo ranks on the CPU, in
both forms the JAX trainer trains: eight heads at every width, and a
diffusers ``unet/config.json``'s 64-wide heads, each with 1x1-conv
projections.

The UNet here has levels of 64 and 128 channels, so the eight-head form
has heads of 8 and 16, and the diffusers form one head at 64 channels
and two at 128 (its mid block): at model 2 the diffusers form splits its
two-head attention and keeps the one-head level whole on every rank, as
SD-1.5's five-head level stays whole at full width; at model 4 it keeps
both whole.  The other towers are ``test_torch_port_train_steps.py``'s,
with a quick_gelu text tower.  Ranks are processes
(``parallel.launch.spawn``, ``torch_port_dist_workers``), each pair or
quartet started once for both forms (``each``), the four groups at once.

* The tensor-parallel forward at data 1 x model 2 and model 4 against the
  JAX UNet's forward (rtol 2e-3, atol 2e-4, as ``tests/test_tp.py``), the
  attentions split where their heads divide ``tp``, the conv projections
  never.
* One tensor-parallel VTO step at model 2 against the single-process
  port step: the loss and every gradient gathered to the reference
  layout within rtol 2e-4, atol 2e-6; the replicated parameters'
  gradients (the conv projections among them) whole, and the same, on
  both ranks.
* The data-parallel step at data 2 (two rows a rank) against the single
  process at the same global batch, at the same limits; ZeRO-1's update
  bitwise the unsharded one, each rank holding part of the AdamW state,
  and a save, restore and second step bitwise two uninterrupted steps.
* ``TryOnService(mesh=)`` at data 1 x model 2 around an eight-head
  pipeline against the one-process service on the same request, within
  ``test_torch_port_parallel_serving.ATOL``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu.models.unet_condition import UNetConfig as JaxUNetConfig
from ladi_vton_tpu_torch.core import checkpoint as ckpt
from ladi_vton_tpu_torch.diffusion.schedulers import make_scheduler
from ladi_vton_tpu_torch.models.emasc import EMASC
from ladi_vton_tpu_torch.models.unet_condition import UNet2DCondition, UNetConfig
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ladi_vton_tpu_torch.parallel import tp
from ladi_vton_tpu_torch.parallel.launch import spawn
from ladi_vton_tpu_torch.pipelines.serving import TryOnService
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from test_torch_port_distributed import ENV, STEP_CFG, TIMEOUT_S
from test_torch_port_parallel_serving import ATOL as SERVE_ATOL
from test_torch_port_parallel_serving import SERVICE, service_request
from test_torch_port_pipeline import CTX, EMASC_IN, EMASC_OUT
from test_torch_port_pipeline import VAE as PIPE_VAE
from test_torch_port_sd15_train import TEXT15, text15_pair
from test_torch_port_train_steps import (
    ADAPTER,
    EMPTY,
    SEQ,
    VAE,
    VISION,
    H,
    T,
    W,
    adapter_pair,
    make_batch,
    pair,
    to_torch,
    vae_pair,
    vto_jax_draws,
)
from torch_port_dist_workers import single_grads

torch.set_num_threads(2)
B = 4
BASE = dict(block_out_channels=(64, 128), layers_per_block=1,
            cross_attention_dim=64, use_linear_projection=False,
            down_block_has_attn=(True, False))
FORMS = {"eight-heads": dict(BASE, head_dim=-1),
         "diffusers": dict(BASE, head_dim=64)}
# the heads of each form's attentions that tp splits
SPLIT = {("eight-heads", 2): {8}, ("eight-heads", 4): {8},
         ("diffusers", 2): {2}, ("diffusers", 4): set()}
TP_RTOL, TP_ATOL = 2e-3, 2e-4
STEP_RTOL, STEP_ATOL = 2e-4, 2e-6


def unet_pair(form: str, seed: int):
    cfg = dict(FORMS[form], in_channels=31)
    jm = JaxUNet(JaxUNetConfig(**cfg), attn_impl="xla")
    v, m = pair(jm, UNet2DCondition(UNetConfig(**cfg)), ckpt.unet_key_map,
                jnp.zeros((1, H // 8, W // 8, 31)), jnp.asarray([0]),
                jnp.zeros((1, SEQ, 64)), seed=seed)
    return jm, v, m


def eight_head_pipeline() -> TryOnPipeline:
    """A seeded tiny try-on pipeline around an eight-head SD-1.5 UNet (the
    parallel serving tests' VAE and EMASC, their context width)."""
    torch.manual_seed(90)
    unet = UNet2DCondition(UNetConfig(
        in_channels=31, **dict(FORMS["eight-heads"],
                               cross_attention_dim=CTX)))
    return TryOnPipeline(unet=unet.eval(),
                         vae=AutoencoderKL(VAEConfig(**PIPE_VAE)).eval(),
                         emasc=EMASC(EMASC_IN, EMASC_OUT).eval(),
                         scheduler=make_scheduler("ddim"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both forms' payloads and JAX forwards, and every group of ranks."""
    _, _, vae = vae_pair()
    _, _, text = text15_pair()
    _, _, adapter = adapter_pair()
    rng = np.random.default_rng(91)
    x = rng.standard_normal((2, H // 8, W // 8, 31)).astype(np.float32)
    t = np.asarray([3, 500])
    ctx = rng.standard_normal((2, SEQ, 64)).astype(np.float32)
    payloads, jax_forward, unets = {}, {}, {}
    for i, form in enumerate(sorted(FORMS)):
        jun, uv, unet = unet_pair(form, 92 + i)
        unets[form] = unet
        jax_forward[form] = np.asarray(jax.jit(jun.apply)(
            uv, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
        payloads[form] = {
            "unet_cfg": dict(in_channels=31, **FORMS[form]), "vae_cfg": VAE,
            "text_cfg": TEXT15, "vision_cfg": VISION,
            "adapter_cfg": ADAPTER,
            "state": {"unet": unet.state_dict(), "vae": vae.state_dict(),
                      "text_model": text.state_dict(),
                      "inversion_adapter": adapter.state_dict()},
            "step_cfg": STEP_CFG, "empty": T(EMPTY).long(),
            "batch": to_torch(make_batch(93 + i, n=B)),
            "draws": vto_jax_draws(jax.random.key(94 + i), B),
            "draws2": vto_jax_draws(jax.random.key(96 + i), B),
            "forward": (T(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                        T(t), T(ctx))}
    forms = sorted(FORMS)
    pipe = eight_head_pipeline()
    serve = {"unet_cfg": dict(in_channels=31,
                              **dict(FORMS["eight-heads"],
                                     cross_attention_dim=CTX)),
             "vae_cfg": PIPE_VAE, "emasc_cfg": (EMASC_IN, EMASC_OUT),
             "service": SERVICE, "mesh": dict(data=1, model=2),
             "state": {"unet": pipe.unet.state_dict(),
                       "vae": pipe.vae.state_dict(),
                       "emasc": pipe.emasc.state_dict()},
             "idle_s": 0.0, "request": service_request(61)}
    work = tmp_path_factory.mktemp("sd15_zero")
    groups = {
        "tp2": (2, ("tp_runs", [(payloads[f],) for f in forms])),
        "tp4": (4, ("tp_runs", [({**payloads[f], "model": 4,
                                  "step": False},) for f in forms])),
        "dp": (2, ("dp_and_zero", [(payloads[f], str(work / f))
                                   for f in forms])),
        "serve": (2, ("serve_rank", [(serve,)]))}
    with ThreadPoolExecutor(len(groups)) as pool:
        futures = {k: pool.submit(spawn, "torch_port_dist_workers:each", n,
                                  args, timeout=TIMEOUT_S, env=ENV)
                   for k, (n, args) in groups.items()}
        # rank r's results, by group, then by form (in ``forms`` order)
        results = {k: f.result() for k, f in futures.items()}
    singles = {f: single_grads(payloads[f]) for f in forms}
    return {"results": results, "jax": jax_forward, "unets": unets,
            "single": singles, "forms": forms, "pipe": pipe}


def form_results(runs, group: str, form: str) -> list:
    """Every rank's result of ``group`` for ``form``."""
    i = runs["forms"].index(form)
    return [r[i] for r in runs["results"][group]]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_tp_forward_matches_jax(runs, form, n):
    results = form_results(runs, f"tp{n}", form)
    assert len(results) == n
    unet = runs["unets"][form]
    heads = tp.attention_heads(unet)
    for r in results:
        out = r["forward"].numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(out, runs["jax"][form], rtol=TP_RTOL,
                                   atol=TP_ATOL)
        split = {heads[k.split(".to_q.")[0]] for k in r["sharded"]
                 if ".to_q." in k}
        assert split == SPLIT[(form, n)]
        assert not any(".proj_in." in k or ".proj_out." in k
                       for k in r["sharded"])
        # every feed-forward is split at any tp
        assert any(".ff.net.0.proj." in k for k in r["sharded"])


@pytest.mark.parametrize("form", sorted(FORMS))
def test_tp_step_matches_the_single_process_step(runs, form):
    results = form_results(runs, "tp2", form)
    single = runs["single"][form]
    for r in results:
        assert r["loss"] == pytest.approx(single["loss"], rel=STEP_RTOL)
        assert sorted(r["grads"]) == sorted(single["grads"])
        for k, g in single["grads"].items():
            torch.testing.assert_close(r["grads"][k], g, rtol=STEP_RTOL,
                                       atol=STEP_ATOL, msg=k)
    a, b = (r["replicated_grads"] for r in results)
    assert any(".proj_in." in k for k in a)
    assert sorted(a) == sorted(b)
    for k, g in a.items():
        assert g.shape == single["grads"][k].shape, k
        torch.testing.assert_close(b[k], g, rtol=STEP_RTOL, atol=STEP_ATOL,
                                   msg=k)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_dp_and_zero1_match_one_process(runs, form):
    results = form_results(runs, "dp", form)
    single = runs["single"][form]
    for r in results:
        dp = r["dp"]
        assert dp["loss"] == pytest.approx(single["loss"], rel=STEP_RTOL)
        for k, g in single["grads"].items():
            torch.testing.assert_close(dp["grads"][k], g, rtol=STEP_RTOL,
                                       atol=STEP_ATOL, msg=k)
        zero = r["zero"]
        assert sorted(zero[True]) == sorted(zero[False])
        assert all(torch.equal(zero[True][k], zero[False][k])
                   for k in zero[False])
        assert 0 < zero["numel_True"] < zero["numel_False"]
        resumed, straight = zero["resumed"], zero["uninterrupted"]
        assert all(torch.equal(resumed[k], straight[k]) for k in straight)
    zeros = [r["zero"] for r in results]
    assert zeros[0]["numel_True"] + zeros[1]["numel_True"] == \
        zeros[0]["numel_False"]


def test_tp_service_matches_one_process(runs):
    (rank0,), _ = runs["results"]["serve"]
    ref = TryOnService(runs["pipe"], **SERVICE).generate(
        **service_request(61))
    ours = rank0["generate"]
    assert ours.shape == ref.shape == (2, SERVICE["height"],
                                       SERVICE["width"], 3)
    err = float(np.abs(ours - ref).max())
    print(f"the eight-head UNet served at model 2 against one process: "
          f"max abs {err:.3e}")
    assert err <= SERVE_ATOL
