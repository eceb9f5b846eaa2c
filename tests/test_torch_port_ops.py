"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart in fp32.  For the three kernel modules the JAX
side runs both its Pallas kernel in interpret mode and its XLA oracle;
the port side is what a CPU tensor takes, the plain PyTorch version.
Each tolerance is stated where it is used.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import ladi_vton_tpu.ops.group_norm as jax_gn
from ladi_vton_tpu.core.checkpoint import export_torch_state, unet_torch_key_map
from ladi_vton_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from ladi_vton_tpu.models.layers import timestep_embedding as jax_temb
from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu.models.unet_condition import UNetConfig as JaxUNetConfig
from ladi_vton_tpu.ops.attention import dot_product_attention as jax_attention
from ladi_vton_tpu.ops.flash_attention import flash_attention as jax_flash
from ladi_vton_tpu.ops.geglu import _geglu as jax_geglu_pallas
from ladi_vton_tpu.ops.geglu import geglu_xla
from ladi_vton_tpu.ops.layer_norm import layer_norm_pallas, layer_norm_xla
from ladi_vton_tpu.ops.resize import resize_bilinear as jax_bilinear
from ladi_vton_tpu.ops.resize import resize_nearest as jax_nearest
from ladi_vton_tpu_torch.core.checkpoint import state_dict_from_jax, unet_key_map
from ladi_vton_tpu_torch.diffusion.schedulers import DDIMScheduler
from ladi_vton_tpu_torch.models.layers import LayerNorm, timestep_embedding
from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.ops.attention import dot_product_attention
from ladi_vton_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_tiling,
)
from ladi_vton_tpu_torch.ops.geglu import (
    BLOCK_K,
    geglu,
    geglu_out_tiling,
    geglu_proj_tiling,
)
from ladi_vton_tpu_torch.ops.group_norm import (
    CLUSTER_VECTORS,
    MAX_CLUSTER,
    SMEM_LIMIT,
    SPLIT_CLUSTER,
    cluster_smem,
    cluster_wave,
    group_norm,
    group_norm_plan,
    split_smem,
)
from ladi_vton_tpu_torch.ops import layer_norm as ln_ops
from ladi_vton_tpu_torch.ops.layer_norm import (
    MAX_VECTORS,
    WARPS,
    WARPS_PER_SM,
    layer_norm,
    layer_norm_plan,
    layer_norm_ref,
)
from ladi_vton_tpu_torch.ops.resize import resize_bilinear, resize_nearest

T = torch.from_numpy


def _nchw(x: np.ndarray) -> torch.Tensor:
    return T(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("sq,sk,heads,d", [(256, 256, 2, 64), (256, 77, 2, 64),
                                           (128, 128, 1, 512)])
def test_attention_matches_pallas_flash_and_xla(sq, sk, heads, d):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, sq, heads, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, heads, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, heads, d)).astype(np.float32)
    ours = dot_product_attention(T(q), T(k), T(v)).numpy()
    # the flash wrapper on a CPU tensor is the same plain version
    np.testing.assert_array_equal(flash_attention(T(q), T(k), T(v)).numpy(),
                                  ours)
    xla = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), impl="xla"))
    pallas = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), interpret=True))
    # fp32 throughout; the sums run in another order (and online in the
    # Pallas kernel), ~1e-6 seen: 1e-5
    np.testing.assert_allclose(ours, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-5)


def test_flash_tiling_fits_each_head_dim():
    # D = 64: two 64-row consumers, 128-row K/V tiles
    assert flash_tiling(64) == (128, 128)
    # D = 512: Q (64 rows) + two K/V stages + the fp32 partial-score swap
    # (2 parities x 2 warpgroups x 64 x block_k) in 227 KB of shared memory
    block_q, block_k = flash_tiling(512)
    assert block_q == 64
    smem = block_q * 512 * 2 + 2 * 2 * block_k * 512 * 2 + 4 * 64 * block_k * 4
    assert smem <= 227 * 1024
    for d in (32, 80, 128):
        with pytest.raises(ValueError, match="head dim"):
            flash_tiling(d)


def test_causal_attention_matches_xla():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 11, 2, 8)).astype(np.float32)
    ours = dot_product_attention(T(q), T(q), T(q), causal=True).numpy()
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(q),
                                   jnp.asarray(q), causal=True, impl="xla"))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- K2 / K3


@pytest.mark.parametrize("act,eps,weights", [("silu", 1e-5, "fp32"),
                                             ("none", 1e-6, "fp32"),
                                             ("silu", 1e-5, "bf16")],
                         ids=["silu-1e-05", "none-1e-06", "silu-1e-05-bf16"])
@pytest.mark.parametrize("two_pass", [False, True], ids=["one_pass",
                                                          "two_pass"])
@pytest.mark.parametrize("channels", [128, 320])
def test_group_norm_matches_pallas_and_xla(channels, two_pass, act, eps,
                                           weights, monkeypatch):
    if two_pass:
        # small slabs always take the one-pass kernel; switch the size
        # rule off so the two-pass kernels (K3) run with 8-row tiles
        monkeypatch.setattr(jax_gn, "_one_pass_profitable", lambda n: False)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 8, 8, channels)) * 2 + 0.5).astype(
        np.float32)
    scale = rng.standard_normal(channels).astype(np.float32)
    bias = rng.standard_normal(channels).astype(np.float32)
    # the towers hold bf16 parameters, which the kernel reads as stored:
    # both sides take the same bf16 values
    wj, bj = jnp.asarray(scale), jnp.asarray(bias)
    wt, bt = T(scale), T(bias)
    if weights == "bf16":
        wj, bj = wj.astype(jnp.bfloat16), bj.astype(jnp.bfloat16)
        wt, bt = wt.to(torch.bfloat16), bt.to(torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(wj.astype(jnp.float32)),
                                      wt.float().numpy())
    xj = jnp.asarray(x)
    pallas = np.asarray(jax_gn.group_norm_pallas(
        xj, wj, bj, eps=eps, act=act, row_tile=8, interpret=True))
    xla = np.asarray(jax_gn.group_norm_xla(xj, wj, bj, eps=eps, act=act))
    before = group_norm.launches
    ours4 = _nhwc(group_norm(_nchw(x).contiguous(
        memory_format=torch.channels_last), wt, bt, eps=eps, act=act))
    ours3 = group_norm(T(x.reshape(2, 64, channels)), wt, bt,
                       eps=eps, act=act).numpy().reshape(x.shape)
    assert group_norm.launches == before  # CPU tensors take the plain path
    np.testing.assert_array_equal(ours4, ours3)
    # same fp32 formula, sums in another order: 1e-5
    np.testing.assert_allclose(ours4, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours4, pallas, rtol=1e-5, atol=1e-5)


# the GroupNorm calls of the try-on path at 512x384 (phase 4's census on
# an H100): the UNet at batch 4 (CFG), the VAE encoder at 4 (cloth and
# masked person of 2 images), the decoder at 2, the VAE mid block at 1
GN_CENSUS = [(4, 3072, 320), (4, 3072, 640), (4, 3072, 960), (4, 768, 320),
             (4, 768, 640), (4, 768, 960), (4, 768, 1280), (4, 768, 1920),
             (4, 192, 640), (4, 192, 1280), (4, 192, 1920), (4, 192, 2560),
             (4, 48, 1280), (4, 48, 2560), (4, 196608, 128),
             (4, 49152, 128), (4, 49152, 256), (4, 12288, 256),
             (4, 12288, 512), (4, 3072, 512), (2, 3072, 512),
             (2, 12288, 512), (2, 49152, 512), (2, 49152, 256),
             (2, 196608, 256), (2, 196608, 128), (1, 3072, 512)]


@pytest.mark.parametrize("B,N,C", GN_CENSUS,
                         ids=[f"{b}x{n}x{c}" for b, n, c in GN_CENSUS])
@pytest.mark.parametrize("sms", [132, 114])
def test_group_norm_plan(B, N, C, sms):
    p = group_norm_plan(B, N, C, sms)
    granule = math.lcm(8, C // 32)
    assert p.smem <= SMEM_LIMIT == 227 * 1024

    def candidates():
        # every range and cluster size the cluster form could take, with
        # whether one wave of its clusters holds the whole tensor
        for ch in range(granule, min(C, 256) + 1, granule):
            if C % ch == 0 and ch // 8 in CLUSTER_VECTORS:
                for cs in (1, 2, 4, MAX_CLUSTER):
                    rows = -(-N // cs)
                    threads = 32 * min(8, -(-rows // (32 // (ch // 8))))
                    smem = cluster_smem(rows, ch, ch // (C // 32), threads, cs)
                    ctas = B * (C // ch) * cs
                    yield (smem <= SMEM_LIMIT and ctas <= cluster_wave(
                        sms, cs, threads, smem))

    if not any(candidates()):
        # no wave of clusters holds the slabs: two launches, statistics
        # in whole clusters, every row in one chunk
        assert p.form == "split" and p.launches == 2
        assert p.channels == C and p.cluster == SPLIT_CLUSTER
        assert p.threads <= 512 and p.threads % (C // 8) == 0
        chunks = p.ctas // B
        assert chunks % p.cluster == 0 and p.ctas == B * chunks
        assert p.rows >= 64 and (p.rows - 1) * chunks < N <= chunks * p.rows
        assert p.smem == split_smem(C, 32, p.threads)
        return
    assert p.form == "cluster" and p.launches == 1
    assert 1 <= p.cluster <= MAX_CLUSTER
    assert p.threads <= 512 and p.threads % 32 == 0
    # ranges of whole groups in 16-byte vectors that tile C
    assert p.channels % granule == 0 and C % p.channels == 0
    assert p.channels // 8 in CLUSTER_VECTORS
    ranges = C // p.channels
    assert p.ctas == B * ranges * p.cluster
    assert p.ctas <= cluster_wave(sms, p.cluster, p.threads, p.smem)
    # CTA r of a cluster holds rows [r * rows, (r + 1) * rows): each row
    # lies in exactly one CTA
    held = np.zeros(N, np.int64)
    for r in range(p.cluster):
        held[r * p.rows:(r + 1) * p.rows] += 1
    assert (held == 1).all()
    assert p.smem == cluster_smem(p.rows, p.channels, p.channels // (C // 32),
                                  p.threads, p.cluster)
    if sms == 132 and C <= 2560 and N <= 3072 and B == 4:
        # the UNet's calls fill the card (one wave, asserted above)
        assert 2 * p.ctas > sms


def test_group_norm_plan_at_the_hot_shape():
    # 4 batch elements x 4 ranges of 80 channels (8 groups; 160-byte rows,
    # whole sectors) x clusters of 8: 128 CTAs, each with 384 rows (61 KB)
    # in shared memory
    p = group_norm_plan(4, 3072, 320)
    assert (p.form, p.cluster, p.channels, p.rows, p.ctas) == (
        "cluster", 8, 80, 384, 128)
    assert p.rows * p.channels * 2 == 61440
    # the H100 SXM's measured cluster capacity at one CTA per SM
    assert cluster_wave(132, 4, 512, 200 * 1024) == 120
    assert cluster_wave(132, 8, 512, 200 * 1024) == 120
    assert [math.lcm(8, C // 32) for C in (320, 960, 2560, 128)] == [
        40, 120, 80, 8]


def test_group_norm_cluster_vectors_match_the_kernel():
    # a plan picks V = channels / 8 from CLUSTER_VECTORS; the cluster-form
    # kernel is built for the V of cluster_kernel()'s cases, and a V missing
    # there would fail only on the card
    src = (_build.CSRC / "group_norm.cu").read_text()
    cases = re.findall(r"case (\d+): return gn_cluster_kernel<(\d+)>;", src)
    assert cases and all(v == t for v, t in cases)
    assert sorted(int(v) for v, _ in cases) == sorted(CLUSTER_VECTORS)


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_geglu_matches_pallas_and_xla(oracle):
    """The port's GEGLU on the CPU against each JAX oracle, one case
    each, so that a failure names the oracle it failed against."""
    rng = np.random.default_rng(4)
    C, I = 640, 2560
    x = rng.standard_normal((1, 64, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, 2 * I)) * C ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(2 * I) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((I, C)) * I ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(C) * 0.1).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    want = np.asarray(geglu_xla(*args) if oracle == "xla"
                      else jax_geglu_pallas(*args, 32, True))
    before = geglu.launches
    # the port takes Linear-layout weights: (2I, C) and (C, I)
    ours = geglu(T(x), T(np.ascontiguousarray(w1.T)), T(b1),
                 T(np.ascontiguousarray(w2.T)), T(b2)).numpy()
    assert geglu.launches == before
    # fp32 products over C=640 and I=2560 in another order, 2e-6 seen;
    # the Pallas kernel's A&S erf (abs error 1.5e-7) adds less: 1e-5
    np.testing.assert_allclose(ours, want, rtol=1e-5, atol=1e-5,
                               err_msg=f"against the {oracle} oracle")


@pytest.mark.parametrize("rows,C", [(4 * 3072, 320), (4 * 768, 640),
                                    (4 * 192, 1280), (4 * 48, 1280),
                                    (2 * 48, 1280), (1, 1280), (77, 320),
                                    (2 * 3072, 320)])
@pytest.mark.parametrize("sms", [132, 114])
def test_geglu_tilings(rows, C, sms):
    inner = 4 * C
    proj = geglu_proj_tiling(rows, C, inner, sms)
    assert proj in (128, 256) and inner % (proj // 2) == 0
    if proj == 256:
        # shared 128-row tiles only where they fill the card and the
        # contraction is deep enough to hide the gate
        assert -(-rows // 128) * (inner // 128) >= sms and C >= 640
    bn, split = geglu_out_tiling(rows, C, inner, sms)
    steps = inner // BLOCK_K
    assert bn in (64, 128, 160, 256) and C % bn == 0
    assert split >= 1 and steps % split == 0
    tiles = -(-rows // 64) * (C // bn)
    if split > 1:
        # only where the tiles alone would leave half the SMs idle, and
        # never below 4 steps a split
        assert 2 * tiles < sms and steps // split >= 4
    if tiles * 2 >= sms:
        assert split == 1


def test_geglu_tilings_at_the_unet_shapes():
    # the widths measured fastest on an H100 (132 SMs): the mid block's
    # 192 rows split the second product 8 ways, 15 tiles -> 120
    expected = {(4 * 3072, 320): (128, (160, 1)),
                (4 * 768, 640): (256, (128, 1)),
                (4 * 192, 1280): (256, (256, 2)),
                (4 * 48, 1280): (128, (256, 8))}
    for (rows, C), (proj, out) in expected.items():
        assert geglu_proj_tiling(rows, C, 4 * C) == proj
        assert geglu_out_tiling(rows, C, 4 * C) == out


# ---------------------------------------------------------------- plain ops


def test_layer_norm_matches_xla():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 24, 320)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(320).astype(np.float32)
    bias = rng.standard_normal(320).astype(np.float32)
    ours = layer_norm_ref(T(x), T(scale), T(bias)).numpy()
    ref = np.asarray(layer_norm_xla(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- K5


@pytest.mark.parametrize("shape", [(2, 24, 320), (4, 16, 640), (2, 1280),
                                   (4, 16, 1280), (2, 77, 1024)],
                         ids=["unet320", "unet640", "cls1280", "unet1280",
                              "text1024_ragged"])
def test_layer_norm_matches_pallas_and_xla(shape):
    rng = np.random.default_rng(10)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, scale, bias)]
    xla = np.asarray(layer_norm_xla(*args))
    # 2 x 77 rows have no 8-row tile, so layer_norm_pallas takes the XLA
    # path there (the port's kernel masks the ragged tail instead)
    pallas = np.asarray(layer_norm_pallas(*args, interpret=True))
    before = layer_norm.launches
    ours = layer_norm(T(x), T(scale), T(bias)).numpy()
    assert layer_norm.launches == before  # CPU tensors take the plain path
    np.testing.assert_array_equal(ours, layer_norm_ref(T(x), T(scale),
                                                       T(bias)).numpy())
    # the same fp32 formula, sums over C in another order: 1e-5
    np.testing.assert_allclose(ours, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-5)


def test_layer_norm_of_the_cls_slice_equals_the_copied_rows():
    x = np.random.default_rng(11).standard_normal((2, 257, 64)).astype(
        np.float32)
    w, b = torch.ones(64), torch.zeros(64)
    cls = T(x)[:, 0, :]
    assert cls.stride(0) == 257 * 64
    np.testing.assert_array_equal(layer_norm(cls, w, b).numpy(),
                                  layer_norm(cls.contiguous(), w, b).numpy())


def test_layer_norm_wrapper_rejects_what_the_kernel_does_not_take():
    # meta tensors are validated as CUDA tensors and raise before a build
    meta = {"device": "meta"}
    x = torch.empty(4, 77, 320, dtype=torch.bfloat16, **meta)
    w = torch.empty(320, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="bf16"):
        layer_norm(x.float(), w, w)
    x100 = torch.empty(4, 77, 100, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="unsupported C"):
        layer_norm(x100, w[:100], w[:100])
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm(x.transpose(0, 1), w, w)
    with pytest.raises(ValueError, match="bias"):
        layer_norm(x, w, w.float())
    with pytest.raises(ValueError, match="weight"):
        layer_norm(x, torch.empty(640, dtype=torch.bfloat16, **meta), w)
    with pytest.raises(ValueError, match="weight"):
        layer_norm(x, torch.ones(320, dtype=torch.bfloat16), w)  # on the CPU
    # the LayerNorm module checks its parameters on its first call, and
    # x on every call
    m = LayerNorm(320).to(**meta)
    with pytest.raises(ValueError, match="weight"):
        m(x)  # fp32 parameters
    m = m.to(torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        m(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        m(x.transpose(0, 1))
    with pytest.raises(ValueError, match="channels"):
        m(torch.empty(4, 77, 640, dtype=torch.bfloat16, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        m(x)  # all else holds: a meta tensor is not launched
    m.bias = torch.nn.Parameter(torch.empty(320, **meta))  # now fp32
    with pytest.raises(ValueError, match="bias"):
        m(x)


def test_layer_norm_module_checks_its_parameters_once(monkeypatch):
    calls = []
    prepare = ln_ops.prepare

    def counted(*args, **kwargs):
        calls.append(args[0].dtype)
        return prepare(*args, **kwargs)

    monkeypatch.setattr(ln_ops, "prepare", counted)
    m = LayerNorm(64).to(device="meta", dtype=torch.bfloat16)
    x = torch.empty(2, 64, dtype=torch.bfloat16, device="meta")
    for _ in range(3):
        with pytest.raises(ValueError, match="CUDA"):
            m(x)
    assert calls == [torch.bfloat16]
    m = m.to(torch.float32)  # the parameters change: checked again
    with pytest.raises(ValueError, match="weight"):
        m(x)
    assert calls == [torch.bfloat16, torch.float32]
    # a CPU tensor takes the plain version and prepares nothing
    cpu = LayerNorm(64)
    xc = torch.randn(3, 64)
    np.testing.assert_array_equal(cpu(xc).detach().numpy(), layer_norm_ref(
        xc, cpu.weight, cpu.bias).detach().numpy())
    assert len(calls) == 2


# the path's LayerNorm calls (rows, C, row stride): the UNet's three levels
# and mid block (batch 4), CLIP text (2 x 77), CLIP vision (2 x 257) and
# the adapter's CLS rows, read through the stride of (2, 257, 1280)
LN_PATH = [(12288, 320, 320), (3072, 640, 640), (768, 1280, 1280),
           (192, 1280, 1280), (154, 1024, 1024), (514, 1280, 1280),
           (2, 1280, 257 * 1280)]


def ln_kernel_cases() -> set:
    src = (_build.CSRC / "layer_norm.cu").read_text()
    return {(int(a), int(b))
            for a, b in re.findall(r"LN_CASE\((\d+), (\d+)\)", src)}


@pytest.mark.parametrize("rows", [1, 2, 7, 77, 154, 192, 514, 768, 3072,
                                  12288, 12288 + 5, 100000])
@pytest.mark.parametrize("sms", [132, 114])
def test_layer_norm_plan(rows, sms):
    cases = ln_kernel_cases()
    for C in range(8, 1281, 8):
        p = layer_norm_plan(rows, C, C, sms)
        nvec = C // 8
        # lanes: a power of two dividing 32, the fewest that hold the row
        # in at most MAX_VECTORS vectors each
        assert 32 % p.lanes == 0 and p.rows_per_warp * p.lanes == 32
        assert p.vectors <= MAX_VECTORS and p.lanes * p.vectors >= nvec
        assert p.lanes == 1 or -(-nvec // (p.lanes // 2)) > MAX_VECTORS
        if C in (320, 640, 1024, 1280):
            assert p.lanes * p.vectors == nvec  # no idle lane on the path
        assert (p.lanes, p.vectors) in cases
        # every row in one row group, every group with one warp: warp k
        # takes groups k, k + grid * warps, ...
        assert p.groups == -(-rows // p.rows_per_warp)
        assert p.warps == WARPS
        # at most one resident wave, and no CTA without a row group; below
        # a wave, one CTA per WARPS row groups
        wave = sms * (WARPS_PER_SM // p.warps)
        assert 1 <= p.grid <= wave
        assert (p.grid - 1) * p.warps < p.groups
        assert p.grid == min(wave, -(-p.groups // p.warps))
    with pytest.raises(ValueError, match="unsupported C"):
        layer_norm_plan(rows, 1288, 1288, sms)
    with pytest.raises(ValueError, match="unsupported C"):
        layer_norm_plan(rows, 320, 324, sms)


def test_layer_norm_plan_at_the_path_shapes():
    # (lanes, vectors, warps, grid) on an H100 SXM
    got = [(p.lanes, p.vectors, p.warps, p.grid)
           for p in (layer_norm_plan(*shape) for shape in LN_PATH)]
    assert got == [(8, 5, 2, 1056), (16, 5, 2, 768), (32, 5, 2, 384),
                   (32, 5, 2, 96), (32, 4, 2, 77), (32, 5, 2, 257),
                   (32, 5, 2, 1)]
    # the UNet's level 0 is one wave, 16 warps an SM: its 3072 row groups
    # of four rows over 2112 warps, none of which takes more than two
    p = layer_norm_plan(12288, 320, 320)
    assert p.grid * p.warps == 132 * WARPS_PER_SM == 2112
    assert p.groups == 3072 <= 2 * 2112


@pytest.mark.parametrize("rows,C,stride", LN_PATH[1:] + [
    (12288 + 5, 320, 320), (7, 1000, 1000), (77, 8, 8), (1, 1280, 1280)])
def test_layer_norm_plan_covers_every_element_once(rows, C, stride):
    # the kernel's walk, restated: warp k of the grid takes row groups
    # k, k + grid * warps, ...; in a group, lane l takes row
    # group * (32 / L) + l // L and vectors l % L + i * L, i < V, those
    # below C / 8
    p = layer_norm_plan(rows, C, stride)
    nvec = C // 8
    seen = np.zeros((rows, nvec), np.int64)
    lane_cols: dict = {}
    total = p.grid * p.warps
    for cta in range(p.grid):
        for warp in range(p.warps):
            k = cta * p.warps + warp
            for g in range(k, p.groups, total):
                for lane in range(32):
                    row = g * p.rows_per_warp + lane // p.lanes
                    cols = tuple(v for v in (lane % p.lanes + i * p.lanes
                                             for i in range(p.vectors))
                                 if v < nvec)
                    if row < rows:
                        seen[row, list(cols)] += 1
                        lane_cols.setdefault((k, lane), set()).add(cols)
    assert (seen == 1).all()
    # a lane covers the same columns in every row it takes: the weight and
    # bias it loads once serve them all
    assert all(len(c) == 1 for c in lane_cols.values())


def test_layer_norm_plan_matches_the_kernel():
    # every (L, V) a plan can pick is instantiated in csrc/layer_norm.cu
    # (a missing one would fail only on the card), and the wave the plan
    # assumes is the kernel's launch bound
    picked = {ln_ops.lanes_and_vectors(C) for C in range(8, 1281, 8)}
    assert picked == ln_kernel_cases()
    src = (_build.CSRC / "layer_norm.cu").read_text()
    max_warps = int(re.search(r"kMaxWarps = (\d+);", src).group(1))
    min_blocks = int(re.search(r"kMinBlocks = (\d+);", src).group(1))
    assert WARPS <= max_warps and WARPS_PER_SM == max_warps * min_blocks
    assert "__launch_bounds__(kMaxWarps * 32, kMinBlocks)" in src


@pytest.mark.parametrize("out_hw", [(8, 6), (37, 29)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_matches_jax(out_hw, align_corners):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 12, 3)).astype(np.float32)
    ours = _nhwc(resize_bilinear(_nchw(x), out_hw,
                                 align_corners=align_corners))
    ref = np.asarray(jax_bilinear(jnp.asarray(x), out_hw,
                                  align_corners=align_corners))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(8, 6), (13, 7), (40, 30)])
def test_resize_nearest_matches_jax(out_hw):
    x = np.random.default_rng(7).standard_normal((1, 16, 12, 2)).astype(
        np.float32)
    ours = _nhwc(resize_nearest(_nchw(x), out_hw))
    np.testing.assert_array_equal(
        ours, np.asarray(jax_nearest(jnp.asarray(x), out_hw)))


def test_timestep_embedding_matches_jax():
    t = np.asarray([0, 1, 21, 500, 981], np.int64)
    for dim in (32, 320, 33):
        ours = timestep_embedding(T(t), dim).numpy()
        ref = np.asarray(jax_temb(jnp.asarray(t), dim))
        # arguments reach ~981 rad, where one fp32 ulp of the argument
        # (6e-5) moves sin/cos by as much: 2e-4
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("steps", [2, 50])
def test_ddim_plan_and_steps_match_jax(steps):
    jsched, ours = JaxDDIM(), DDIMScheduler()
    plan = jsched.set_timesteps(steps)
    ours_plan = ours.set_timesteps(steps)
    assert ours_plan.tolist() == [int(t) for t in plan]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    for i in [0, 1, 2, steps - 2, steps - 1][-min(steps, 5):]:
        t = int(ours_plan[i])
        eps = rng.standard_normal(x.shape).astype(np.float32)
        ref = np.asarray(jsched.step(jnp.asarray(eps), jnp.asarray(t),
                                     jnp.asarray(x)))
        _, got = ours.loop_step((), T(eps), torch.tensor(i), ours_plan[i],
                                T(x))
        got = got.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        x = np.array(ref)


def test_state_dict_from_jax_matches_export_torch_state():
    unet = JaxUNet(JaxUNetConfig(in_channels=31,
                                 block_out_channels=(32, 64, 64, 64),
                                 head_dim=8, cross_attention_dim=64))
    shapes = jax.eval_shape(unet.init, jax.random.key(0),
                            jnp.zeros((1, 8, 8, 31)), jnp.asarray([0]),
                            jnp.zeros((1, 7, 64)))
    rng = np.random.default_rng(9)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_dict(shapes).items()}
    ours = state_dict_from_jax(flat, unet_key_map)
    ref = export_torch_state(unflatten_dict(flat), None,
                             key_map=unet_torch_key_map)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert ours[key].shape == value.shape, key
        np.testing.assert_array_equal(ours[key].numpy(), value.numpy())


def test_wrappers_reject_what_the_kernels_do_not_take():
    # meta tensors are not CPU tensors, so the wrappers validate them as
    # they would a CUDA tensor and raise before any build or launch
    meta = {"device": "meta"}
    q = torch.empty(1, 16, 2, 32, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q.float(), q.float(), q.float())
    x = torch.empty(2, 64, 4, 4, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="channels_last"):
        group_norm(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="bf16"):
        group_norm(x.float(), torch.ones(64), torch.zeros(64))
    # weight and bias reach the kernel as stored: bf16 or fp32, both alike
    xc = x.contiguous(memory_format=torch.channels_last)
    w16 = torch.empty(64, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="weight and bias"):
        group_norm(xc, w16, torch.empty(64, **meta))
    with pytest.raises(ValueError, match="weight and bias"):
        group_norm(xc, w16.half(), w16.half())
    with pytest.raises(ValueError, match="weight and bias"):
        group_norm(xc, torch.ones(64), torch.zeros(64))  # on the CPU
    h = torch.empty(4, 96, dtype=torch.bfloat16, **meta)
    w1 = torch.empty(768, 96, dtype=torch.bfloat16, **meta)
    w2 = torch.empty(96, 384, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="multiples of 64"):
        geglu(h, w1, torch.empty(768, **meta), w2, torch.empty(96, **meta))
    # the biases reach the kernels as stored: bf16 or fp32, contiguous
    x = torch.empty(4, 64, dtype=torch.bfloat16, **meta)
    w1 = torch.empty(512, 64, dtype=torch.bfloat16, **meta)
    w2 = torch.empty(64, 256, dtype=torch.bfloat16, **meta)
    b2 = torch.empty(64, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="b1 must be a contiguous bf16 or"):
        geglu(x, w1, torch.empty(512, dtype=torch.float16, **meta), w2, b2)
    with pytest.raises(ValueError, match="b2 must be a contiguous bf16 or"):
        geglu(x, w1, torch.empty(512, **meta), w2,
              torch.empty(128, **meta)[::2])
    # TMA needs a 16-byte aligned base and 16-byte multiples as strides
    q = torch.empty(1, 16, 2, 64, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, q.as_strided(q.shape, (2044, 132, 66, 1)), q)
