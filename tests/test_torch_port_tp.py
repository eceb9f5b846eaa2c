"""The port's tensor parallelism (``parallel.tp``) against the JAX
package's, on the CPU.

* The plan: the leaves the port splits, and along which axis, are those
  the JAX ``unet_tp_specs`` shards, mapped through ``unet_key_map`` (a
  JAX kernel's axis 1 is a torch weight's axis 0); everything else is
  replicated; an axis that does not divide ``tp`` is refused with its key
  (``tests/test_tp.py``); sharding a state dict and gathering the slices
  back is bitwise the identity; the value ‖ gate slices of ``geglu_ref``,
  with b2 on rank 0 only, sum to the whole.
* Two gloo ranks at data 1 x model 2 (fp32): the tensor-parallel UNet's
  forward against the JAX UNet's at ``tests/test_tp.py``'s tolerance
  (rtol 2e-3, atol 2e-4), and one tensor-parallel VTO step's loss and its
  gradients, gathered back to the reference layout, against the
  single-process port step's (rtol 2e-4, atol 2e-6, as the JAX 2-D step
  test), with the ``to_q`` weights really split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ladi_vton_tpu.parallel.tp import unet_tp_specs as jax_unet_tp_specs
from ladi_vton_tpu_torch.core import checkpoint as ckpt
from ladi_vton_tpu_torch.ops.geglu import geglu_ref
from ladi_vton_tpu_torch.parallel import tp
from test_torch_port_distributed import ENV, STEP_CFG, TIMEOUT_S
from test_torch_port_train_steps import (
    ADAPTER,
    EMPTY,
    H,
    SEQ,
    T,
    TEXT,
    UNET,
    VAE,
    VISION,
    W,
    adapter_pair,
    make_batch,
    text_pair,
    to_torch,
    unet_pair,
    vae_pair,
    vto_jax_draws,
)
from ladi_vton_tpu_torch.parallel.launch import spawn


@pytest.fixture(scope="module")
def pair():
    return unet_pair(31, 14)


def jax_split_axes(variables) -> dict:
    """torch key -> the torch axis the JAX plan shards (its leaves with a
    ``model`` entry)."""
    params = flatten_dict(variables)
    specs = flatten_dict(jax_unet_tp_specs(variables))
    out = {}
    for path, spec in specs.items():
        if "model" not in tuple(spec):
            continue
        axis = tuple(spec).index("model")
        key, _ = ckpt._to_torch_key_value(path[1:], np.asarray(params[path]))
        key = ckpt.unet_key_map(key)
        ndim = np.ndim(params[path])
        out[key] = 1 - axis if ndim == 2 else axis
    return out


def test_plan_covers_the_jax_plan(pair):
    _, variables, unet = pair
    specs = tp.unet_tp_specs(unet.state_dict())
    ours = {k: axis for k, s in specs.items() if s is not None
            for axis in (s[1],)}
    assert ours == jax_split_axes(variables)
    kinds = {s[0] for s in specs.values() if s is not None}
    assert kinds == {tp.COLUMN, tp.GEGLU_COLUMN, tp.ROW}
    assert all(s is None for k, s in specs.items()
               if "transformer_blocks" not in k)


def test_indivisible_axis_is_refused(pair):
    _, _, unet = pair
    # 64 channels of 8 heads: tp 3 divides nothing
    with pytest.raises(ValueError, match="does not divide .*to_q.weight"):
        tp.tp_shardings(unet.state_dict(), 3)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_then_gather_is_the_identity(pair, n):
    _, _, unet = pair
    sd = unet.state_dict()
    specs = tp.unet_tp_plan(unet, n)
    shards = [tp.tp_shard_state_dict(sd, r, n, specs) for r in range(n)]
    q = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert shards[1][q].shape[0] * n == sd[q].shape[0]
    back = tp.tp_gather_state_dict(shards, specs)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_value_gate_slices_sum_to_the_whole():
    rng = np.random.default_rng(0)
    C, inner, n = 16, 32, 4
    f = lambda *s: T(rng.standard_normal(s).astype(np.float64))  # noqa
    x, w1, b1, w2, b2 = f(5, C), f(2 * inner, C), f(2 * inner), \
        f(C, inner), f(C)
    spec = (tp.GEGLU_COLUMN, 0)
    parts = [geglu_ref(x, tp._shard(w1, spec, r, n), tp._shard(b1, spec, r, n),
                       w2.chunk(n, dim=1)[r], b2 if r == 0 else 0 * b2)
             for r in range(n)]
    torch.testing.assert_close(sum(parts), geglu_ref(x, w1, b1, w2, b2),
                               rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def runs(pair):
    """The tensor-parallel forward and step on two ranks, and the
    single-process step, from the same payload."""
    jun, uv, unet = pair
    _, _, vae = vae_pair()
    _, _, text = text_pair()
    _, _, adapter = adapter_pair()
    rng = np.random.default_rng(50)
    x = rng.standard_normal((2, H // 8, W // 8, 31)).astype(np.float32)
    t = np.asarray([3, 500])
    ctx = rng.standard_normal((2, SEQ, 64)).astype(np.float32)
    payload = {
        "unet_cfg": dict(in_channels=31, **UNET), "vae_cfg": VAE,
        "text_cfg": TEXT, "vision_cfg": VISION, "adapter_cfg": ADAPTER,
        "state": {"unet": unet.state_dict(), "vae": vae.state_dict(),
                  "text_model": text.state_dict(),
                  "inversion_adapter": adapter.state_dict()},
        "step_cfg": STEP_CFG, "empty": T(EMPTY).long(),
        "batch": to_torch(make_batch(51)),
        "draws": vto_jax_draws(jax.random.key(52), 2),
        "forward": (T(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                    T(t), T(ctx))}
    results = spawn("torch_port_dist_workers:tp_runs", 2, (payload,),
                    timeout=TIMEOUT_S, env=ENV)
    from torch_port_dist_workers import single_grads

    ref_out = jun.apply(uv, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    return results, single_grads(payload), np.asarray(ref_out), unet


def test_tp_unet_forward_matches_jax(runs):
    results, _, ref, unet = runs
    for r in results:
        out = r["forward"].numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-4)
    # every attention and feed-forward is split (8 heads a level)
    q = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert results[0]["q_shape"][0] * 2 == unet.state_dict()[q].shape[0]
    assert q in results[0]["sharded"]


def test_tp_train_step_matches_the_single_process_step(runs):
    results, single, _, _ = runs
    for r in results:
        assert r["loss"] == pytest.approx(single["loss"], rel=2e-4)
        assert sorted(r["grads"]) == sorted(single["grads"])
        for k, g in single["grads"].items():
            torch.testing.assert_close(r["grads"][k], g, rtol=2e-4,
                                       atol=2e-6, msg=k)
