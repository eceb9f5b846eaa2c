"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart in fp32.  For the three kernel modules the JAX
side runs both its Pallas kernel in interpret mode and its XLA oracle;
the port side is what a CPU tensor takes, the plain PyTorch version.
Each tolerance is stated where it is used.
"""

import functools
import math
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

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
    ACC_REG_RESERVE,
    flash_attention,
    flash_plan,
)
from ladi_vton_tpu_torch.ops.flash_attention import SMEM_LIMIT as K1_SMEM
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
                                           (128, 128, 1, 512),
                                           # the SD-1.5 UNet's head dims
                                           (256, 256, 2, 40), (256, 77, 2, 40),
                                           (192, 192, 2, 80), (192, 77, 2, 80),
                                           (96, 96, 2, 160), (96, 77, 2, 160)])
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


def _extract(src: str, pattern: str) -> str:
    found = re.findall(pattern, src, flags=re.S | re.M)
    assert len(found) == 1, pattern
    return found[0]


@functools.lru_cache(maxsize=None)
def _kernel_tilings() -> dict:
    """Each tiling K1's source launches, with the constants the source
    computes for it, keyed (head dim, block_q, block_k): ``Cols`` and
    ``Fit`` at every (BK, BQ) that ``small<D>`` dispatches (D = 40, 80,
    160), ``Panels<64>`` and ``d512``, compiled from
    ``csrc/flash_attention.cu`` with the host C++ compiler (the swizzle
    modes stood in by their spans in bytes)."""
    src = (Path(_build.CSRC) / "flash_attention.cu").read_text()
    structs = "\n".join(_extract(src, pattern) for pattern in (
        r"^constexpr int kSmemLimit = [^\n]*",
        r"^constexpr int up1024\([^\n]*",
        r"^template <int D>\nstruct Panels \{.*?^\};",
        r"^namespace d512 \{.*?^\}  // namespace d512",
        r"^template <int D>\nstruct Cols \{.*?^\};",
        r"^template <int D, int BK, int BQ>\nstruct Fit \{.*?^\};"))
    small = _extract(src, r"^int small\(.*?^\}")
    consts = "\n".join(re.findall(r"^\s*constexpr int \w+ = [^\n]*", small,
                                  flags=re.M))
    launches = re.findall(r"small_launch<D, (\w+), (\w+)>", small)
    assert len(launches) == 3, launches
    shows = " ".join(f"show<D, {bk}, {bq}>();" for bk, bq in launches)
    program = f"""#include <cstdint>
#include <cstdio>
constexpr uint32_t kSwizzle128 = 128, kSwizzle64 = 64, kSwizzle32 = 32;
{structs}
template <int D, int BK, int BQ> void show() {{
  using L = Fit<D, BK, BQ>;
  using C = Cols<D>;
  std::printf("%d %d %d %d %d %d %d %d %d %d %d %d %d %d\\n", D, BQ, BK,
              C::NP, C::LAST, (int)C::LAST_SWIZZLE, C::N0, C::N1, L::QST,
              L::ST, L::SMEM, L::CONSUMER_REGS, L::ACC_REGS, (int)L::SPLIT);
}}
template <int D> void tilings() {{
{consts}
  {shows}
}}
int main() {{
  tilings<40>(); tilings<80>(); tilings<160>();
  using P = Panels<64>;
  std::printf("64 %d %d %d %d\\n", P::BQ, P::BK, P::QST, P::ST);
  std::printf("%d\\n", P::SMEM);
  std::printf("512 %d %d %d\\n", d512::BQ, d512::BK, d512::ST);
  std::printf("%d\\n", d512::SMEM);
}}
"""
    cxx = shutil.which("g++") or shutil.which("c++")
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "fit.cpp").write_text(program)
        subprocess.run([cxx, "-std=c++17", "-o", f"{tmp}/fit", f"{tmp}/fit.cpp"],
                       check=True)
        lines = subprocess.run([f"{tmp}/fit"], check=True, capture_output=True,
                               text=True).stdout.split("\n")
    fields = ("panels", "swizzles", "pv_widths", "q_stages", "kv_stages",
              "smem", "consumer_regs", "acc_regs", "split")
    out = {}
    for line in lines[:9]:
        (d, bq, bk, np_, last, swizzle, n0, n1, qst, st, smem, regs, acc,
         split) = map(int, line.split())
        out[d, bq, bk] = dict(zip(fields, (
            (64,) * (np_ - 1) + (last,), (128,) * (np_ - 1) + (swizzle,),
            tuple(n for n in (n0, n1) if n), qst, st, smem, regs, acc,
            bool(split))))
    d, bq, bk, qst, st = map(int, lines[9].split())
    out[d, bq, bk] = {"q_stages": qst, "kv_stages": st,
                      "smem": int(lines[10])}
    d, bq, bk, st = map(int, lines[11].split())
    out[d, bq, bk] = {"kv_stages": st, "smem": int(lines[12])}
    return out


# (B * H, Sq, Sk) of the SD-2 and SD-1.5 UNets' calls at batch 4 (eight
# and four heads, self- and cross-attention), the trainers' batch 1, a
# ragged shape and the VAE's single head
PLAN_SHAPES = [(32, 3072, 3072), (32, 3072, 77), (32, 768, 768),
               (16, 768, 768), (32, 768, 77), (32, 192, 192), (16, 192, 192),
               (32, 48, 48), (32, 48, 77), (8, 3072, 3072), (8, 768, 768),
               (8, 192, 192), (16, 1000, 300), (8, 1000, 300), (1, 3072, 3072),
               (20, 3072, 3072)]


@pytest.mark.parametrize("d", [40, 64, 80, 160, 512])
def test_flash_tiling_fits_each_head_dim(d):
    for bh, sq, sk in PLAN_SHAPES:
        plan = flash_plan(d, sq, sk, bh)
        assert plan.head_dim == d
        # every product's N is a legal wgmma N: the S tile (block_k), P V's
        # products, each panel (a K-major k-step reads 16 of its columns)
        for n in (plan.block_k, *plan.pv_widths, *plan.panels):
            assert n % 8 == 0 and 8 <= n <= 256, (d, n)
        assert plan.panels[0] == 64 and sum(plan.panels) >= d
        # P V at N = D (at D = 512 each consumer's half of D)
        assert sum(plan.pv_widths) == (d // 2 if d == 512 else d)
        # a TMA box's inner bytes are its swizzle's span
        assert plan.swizzles == tuple(2 * w for w in plan.panels)
        assert all(s in (32, 64, 128) for s in plan.swizzles)
        # the rings (and D = 512's exchange, the split form's) fit 227 KB
        row = 2 * sum(plan.panels)
        rings = (plan.q_stages * plan.block_q * row
                 + 2 * plan.kv_stages * plan.block_k * row)
        assert rings < plan.smem <= K1_SMEM == 227 * 1024
        assert plan.kv_stages >= (3 if plan.split else 2)
        # a tiling the source launches, each number as the source has it
        source = _kernel_tilings()[d, plan.block_q, plan.block_k]
        assert {k: getattr(plan, k) for k in source} == source
        # S, O and the packed P fit a consumer thread's registers: 232
        # beside one other consumer, 160 beside two (with the producer's
        # 32: 128 * 32 + 384 * 160 = 64K)
        consumers = 2 if plan.split or d == 512 else plan.block_q // 64
        assert plan.consumer_regs == {2: 232, 3: 160}[consumers]
        assert plan.acc_regs + ACC_REG_RESERVE <= plan.consumer_regs
        if d in (64, 512):  # one tiling each, whatever the shape
            assert plan == flash_plan(d, 1, 1)
            continue
        assert plan.pv_widths == {40: (40,), 80: (64, 16),
                                  160: (128, 32)}[d]
        # the 77-token context takes one 80-column key tile, unless the
        # split form's 64-row items fill more SMs
        assert plan.block_k == (80 if sk <= 80 and not plan.split else
                                64 if d == 160 and plan.split else 128)
        # three consumers of 64 q rows at D = 40 against 128-row K/V tiles
        assert plan.block_q == (64 if plan.split else 192 if d == 40
                                and plan.block_k == 128 else 128)
        if sk == 77 and (d, sq) in ((40, 3072), (80, 768)):
            assert plan.block_k == 80  # the path's cross-attention
    # the split form where 128-row items leave SMs idle: eight heads at
    # S = 768 (192 items on 132 SMs), D = 160 at S = 192; not at S = 3072
    # (D = 40's 192-row items: 512 at batch 4, 128 at batch 1) nor at
    # S = 768 with four heads (96 items: one round)
    expect = {40: (False, False, False), 80: (True, False, True),
              160: (True, True, True)}.get(d)
    if d == 160:  # S = 192 and 48, Sk = 77 and 48: 64-row items
        assert all(flash_plan(160, sq, sk, 32).split
                   for sq, sk in ((192, 77), (48, 48), (48, 77)))
    if expect:
        assert tuple(flash_plan(d, sq, sk, bh).split for bh, sq, sk in
                     ((32, 768 if d != 40 else 3072, 768 if d != 40 else 3072),
                      (16, 192 if d == 160 else 768,
                       192 if d == 160 else 768),
                      (8, 3072 if d == 40 else 768,
                       3072 if d == 40 else 768))) == expect
    for bad in (32, 96, 128):
        with pytest.raises(ValueError, match="head dim"):
            flash_plan(bad, 256, 256)


def _kernel_constants() -> dict:
    """The FMA exp2's constants as ``csrc/flash_attention.cu`` states them
    (C hex floats, and its share of 16)."""
    src = (Path(_build.CSRC) / "flash_attention.cu").read_text()
    consts = {name: float.fromhex(value) if "0x" in value else float(value)
              for name, value in re.findall(
                  r"constexpr float (kExp2\w+) = ([-+0-9a-fA-Fx.p]+)f;", src)}
    share = re.search(r"constexpr int kPolyShare = (\d+);", src)
    consts["share"] = int(share.group(1))
    return consts


def _poly_exp2(x: torch.Tensor, c: dict) -> torch.Tensor:
    """The kernel's poly_exp2 in float32 on the CPU: clamp, floor by the
    shift (an add rounded down gives floor(x) + shift exactly), fraction,
    Horner by fused multiply-adds (one rounding each), the floor shifted
    into the exponent field."""
    f32 = torch.float32

    def fma(a, b, k):
        return (a.double() * b.double() + k.double()).to(f32)

    x = torch.clamp(x, min=c["kExp2Min"])
    t = torch.floor(x) + torch.tensor(c["kExp2Shift"], dtype=f32)
    f = x - (t - torch.tensor(c["kExp2Shift"], dtype=f32))
    p = torch.full_like(f, c["kExp2C3"])
    for k in (c["kExp2C2"], c["kExp2C1"], 1.0):
        p = fma(p, f, torch.full_like(f, k))
    shift = (t - c["kExp2Shift"]).to(torch.int32) << 23
    return (p.view(torch.int32) + shift).view(f32)


def test_fma_exp2_matches_exp2():
    c = _kernel_constants()
    assert set(c) == {"kExp2C1", "kExp2C2", "kExp2C3", "kExp2Shift",
                      "kExp2Min", "share"}
    assert c["kExp2Shift"] == 1.5 * 2 ** 23 and c["kExp2Min"] == -127.0
    # a share of 16 exponentials, some on each pipe
    assert 0 < c["share"] < 16
    rng = np.random.default_rng(3)
    x = np.concatenate([np.linspace(-126.0, 0.0, 1_000_001),
                        -rng.random(200_000) * 2.0,
                        -rng.random(200_000) * 126.0,
                        [0.0, -1e-30, -126.0, -0.5, -1.0]]).astype(np.float32)
    got = _poly_exp2(torch.from_numpy(x), c).double().numpy()
    ref = np.exp2(x.astype(np.float64))
    rel = np.abs(got - ref) / ref
    # the bound the design states: far under bf16's half ulp of 2^-9
    assert rel.max() < 2.0 ** -12, rel.max()
    # a masked column (-inf) gives +0 exactly, as ex2.approx does
    inf = _poly_exp2(torch.tensor([-np.inf, -200.0], dtype=torch.float32), c)
    assert inf.tolist() == [0.0, 0.0]
    assert not torch.signbit(inf).any()


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
