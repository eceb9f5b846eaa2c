"""Gradients through the port's kernel wrappers, against the JAX package.

Each wrapper (K1 flash attention, K2/K3 GroupNorm with and without SiLU,
K4 GEGLU, K5 LayerNorm) differentiates through a
``torch.autograd.Function`` whose forward launches the kernel and whose
backward recomputes the plain ``*_ref`` (``ops._autograd``), as each JAX
kernel's ``custom_vjp`` recomputes its XLA oracle.  There is no card
here, so the Function's launch (``_launch``) is monkeypatched to the plain
forward; the Function's own backward then runs on the CPU.  Its
gradients, for a random cotangent, must match the JAX op's VJP with the
Pallas kernel in interpret mode within 1e-5 relative L2 (fp32; sums in
another order), and equal, bit for bit, plain autograd of the ``*_ref``
(the same recompute).  Also: which calls take the Function (meta tensors
stand in for CUDA ones: not CPU, so the wrappers treat them as the card's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ladi_vton_tpu.ops.group_norm as jax_gn
from ladi_vton_tpu.ops.flash_attention import flash_attention as jax_flash
from ladi_vton_tpu.ops.geglu import _geglu as jax_geglu_pallas
from ladi_vton_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from ladi_vton_tpu_torch.models.layers import LayerNorm
from ladi_vton_tpu_torch.ops import flash_attention as fa
from ladi_vton_tpu_torch.ops import geglu as gg
from ladi_vton_tpu_torch.ops import group_norm as gn
from ladi_vton_tpu_torch.ops import layer_norm as ln
from ladi_vton_tpu_torch.ops.attention import attention_ref

torch.set_num_threads(2)
RTOL = 1e-5


def rel_l2(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


def leaves(arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def port_grads(fn, arrays, cotangent):
    inputs = leaves(arrays)
    out = fn(*inputs)
    out.backward(torch.from_numpy(cotangent))
    return out.detach().numpy(), [t.grad.numpy() for t in inputs]


def jax_grads(fn, arrays, cotangent):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(
        cotangent))]


def check(function, ref, arrays, cotangent, jax_out, jax_g, transpose=()):
    """The Function against JAX and against plain autograd of ``ref``."""
    out, grads = port_grads(function, arrays, cotangent)
    _, plain = port_grads(ref, arrays, cotangent)
    for i, (g, p, j) in enumerate(zip(grads, plain, jax_g)):
        np.testing.assert_array_equal(g, p)
        j = j.T if i in transpose else j
        assert g.shape == j.shape
        err = rel_l2(g, j)
        assert err < RTOL, (i, err)
    assert rel_l2(out, jax_out) < RTOL


@pytest.mark.parametrize("sq,sk,heads", [(128, 128, 2), (128, 77, 2)],
                         ids=["self", "cross"])
def test_flash_attention_gradient(sq, sk, heads, monkeypatch):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, sq, heads, 64)).astype(np.float32)
    k = rng.standard_normal((1, sk, heads, 64)).astype(np.float32)
    v = rng.standard_normal((1, sk, heads, 64)).astype(np.float32)
    g = rng.standard_normal(q.shape).astype(np.float32)
    monkeypatch.setattr(fa, "_launch", lambda q, k, v, scale: attention_ref(
        q, k, v, scale=scale))
    scale = 64 ** -0.5
    jax_out, jax_g = jax_grads(
        lambda q, k, v: jax_flash(q, k, v, interpret=True), (q, k, v), g)
    check(lambda q, k, v: fa.FlashAttention.apply(q, k, v, scale),
          lambda q, k, v: attention_ref(q, k, v, scale=scale),
          (q, k, v), g, jax_out, jax_g)


@pytest.mark.parametrize("two_pass", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("act", ["silu", "none"])
def test_group_norm_gradient(act, two_pass, monkeypatch):
    if two_pass:  # the two-pass kernels, as test_torch_port_ops runs them
        monkeypatch.setattr(jax_gn, "_one_pass_profitable", lambda n: False)
    rng = np.random.default_rng(1)
    C = 128
    x = (rng.standard_normal((2, 8, 8, C)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    eps = 1e-5
    monkeypatch.setattr(gn, "_launch", lambda x, w, b, G, eps, act:
                        gn.group_norm_ref(x, w, b, num_groups=G, eps=eps,
                                          act=act))
    jax_out, jax_g = jax_grads(
        lambda x, w, b: jax_gn.group_norm(x, w, b, eps=eps, act=act,
                                          impl="pallas"), (x, w, b), g)
    # the port reads the same NHWC values as (B, H*W, C) rows
    rows = lambda a: a.reshape(2, 64, C)  # noqa: E731
    out, grads = port_grads(
        lambda x, w, b: gn.GroupNormFn.apply(x, w, b, 32, eps, act),
        (rows(x), w, b), rows(g))
    _, plain = port_grads(
        lambda x, w, b: gn.group_norm_ref(x, w, b, eps=eps, act=act),
        (rows(x), w, b), rows(g))
    for ours, p, ref in zip(grads, plain, jax_g):
        np.testing.assert_array_equal(ours, p)
        assert rel_l2(ours.reshape(ref.shape), ref) < RTOL
    assert rel_l2(out.reshape(jax_out.shape), jax_out) < RTOL


def test_geglu_gradient(monkeypatch):
    rng = np.random.default_rng(2)
    C, I = 64, 256
    x = rng.standard_normal((1, 16, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, 2 * I)) * C ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(2 * I) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((I, C)) * I ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(C) * 0.1).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    monkeypatch.setattr(gg, "_launch", gg.geglu_ref)
    jax_out, jax_g = jax_grads(
        lambda *a: jax_geglu_pallas(*a, 16, True), (x, w1, b1, w2, b2), g)
    # the port takes Linear-layout weights: (2I, C) and (C, I)
    linear = (x, np.ascontiguousarray(w1.T), b1, np.ascontiguousarray(w2.T),
              b2)
    check(gg.GEGLU.apply, gg.geglu_ref, linear, g, jax_out, jax_g,
          transpose=(1, 3))


@pytest.mark.parametrize("shape", [(2, 24, 320), (2, 77, 64)],
                         ids=["unet", "text"])
def test_layer_norm_gradient(shape, monkeypatch):
    rng = np.random.default_rng(3)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    monkeypatch.setattr(ln, "_launch", lambda x, w, b, eps, prepared=None:
                        ln.layer_norm_ref(x, w, b, eps=eps))
    jax_out, jax_g = jax_grads(
        lambda x, w, b: jax_layer_norm(x, w, b, impl="pallas"), (x, w, b), g)
    check(lambda x, w, b: ln.LayerNormFn.apply(x, w, b, 1e-5),
          lambda x, w, b: ln.layer_norm_ref(x, w, b), (x, w, b), g,
          jax_out, jax_g)


def test_wrappers_take_the_function_only_for_a_gradient(monkeypatch):
    """Meta tensors are not CPU tensors, so each wrapper dispatches them as
    CUDA ones: through its Function where an input needs a gradient
    (the output gets the Function's grad_fn), straight to the launch
    otherwise; every launch counts once either way."""
    launched = []

    def fake(name):
        def launch(x, *args, **kwargs):
            launched.append(name)
            return torch.empty_like(x)
        return launch

    for mod in (fa, gn, gg, ln):
        monkeypatch.setattr(mod, "_launch", fake(mod.__name__))
    meta = dict(device="meta")
    q = torch.empty(1, 128, 2, 64, **meta)
    x4 = torch.empty(2, 64, 4, 4, **meta)
    w64 = torch.empty(64, **meta)
    x = torch.empty(4, 64, **meta)
    w1, b1 = torch.empty(512, 64, **meta), torch.empty(512, **meta)
    w2 = torch.empty(64, 256, **meta)
    calls = {
        "flash": (fa.flash_attention, (q, q, q), "FlashAttentionBackward"),
        "group_norm": (gn.group_norm, (x4, w64, w64), "GroupNormFnBackward"),
        "geglu": (gg.geglu, (x, w1, b1, w2, w64), "GEGLUBackward"),
        "layer_norm": (ln.layer_norm, (x, w64, w64), "LayerNormFnBackward"),
    }
    for name, (fn, args, backward) in calls.items():
        out = fn(*args)
        assert out.grad_fn is None, name
        grad_args = [a.clone().requires_grad_() for a in args]
        out = fn(*grad_args)
        assert type(out.grad_fn).__name__ == backward, name
        with torch.no_grad():
            assert fn(*grad_args).grad_fn is None, name
    assert len(launched) == 3 * len(calls)
    # the LayerNorm module: its prepared parameters go to the Function
    m = LayerNorm(64).to(device="meta", dtype=torch.bfloat16)
    seen = []
    monkeypatch.setattr(ln, "_launch", lambda x, w, b, eps, prepared=None:
                        seen.append(prepared) or torch.empty_like(x))
    monkeypatch.setattr(ln, "prepare", lambda w, b, eps: ("prepared", eps))
    out = m(torch.empty(2, 64, dtype=torch.bfloat16, device="meta"))
    assert type(out.grad_fn).__name__ == "LayerNormFnBackward"
    assert seen == [("prepared", 1e-5)]
