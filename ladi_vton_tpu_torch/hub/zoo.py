"""Model zoo: the reference's checkpoints as the port's torch modules.

Counterpart of ``ladi_vton_tpu/hub/zoo.py``.  The port's modules carry
the reference's state-dict names, so a checkpoint loads with a strict
``load_state_dict`` and no conversion.  Each loader returns the module
on ``device`` ("cuda" unless the caller asks for "cpu"; asking for CUDA
where there is none raises) in ``dtype``.  The release files resolve as
in the JAX zoo:

1. a local checkpoint path (``checkpoint=...``),
2. a checkpoint directory (``checkpoint_dir/<name>_<dataset>.pth``),
3. the reference's release URL, downloaded into ``$LADI_VTON_CACHE``
   (default ``~/.cache/ladi_vton_tpu``) only where there is a network.

A ``<name>_<dataset>.config.json`` sidecar next to a ``.pth`` overrides
the built-in architecture, and the SD-2 and CLIP model directories are
read through their diffusers/transformers ``config.json``
(``tools/make_weights.py --tiny`` writes both); ``_config_kwargs`` keeps
the keys the port's config dataclasses know.  Subfolder checkpoints are
``.bin`` (``torch.load(weights_only=True)``) or ``.safetensors``, read
by ``load_safetensors`` (the format is simple enough that the port needs
no package for it).  The EMASC's ``kind`` and ``kernel_size`` come from
the caller, as the reference's eval flags give them.

Files may carry entries the port's towers do not model, which are
dropped before the strict load: ``position_ids`` buffers, and in a CLIP
checkpoint everything outside ``vision_model.`` plus the vision
``post_layernorm`` (the try-on path reads the last hidden state).  A
BatchNorm without the ``num_batches_tracked`` counter, as the JAX
package's export writes it, gets torch's 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import urllib.request
from pathlib import Path
from typing import Callable, Optional

import torch

from ladi_vton_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    CLIPVisionConfig,
    CLIPVisionModel,
    sd2_text_config,
    vit_h_vision_config,
)
from ladi_vton_tpu_torch.models.emasc import EMASC
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.models.tps import ConvNetTPS
from ladi_vton_tpu_torch.models.unet_condition import (
    UNet2DCondition,
    UNetConfig,
    sd2_unet_config,
)
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig

RELEASE_URL = "https://github.com/miccunifi/ladi-vton/releases/download/weights"

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def load_safetensors(path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors: an 8-byte little-endian
    header length, a JSON header ``{name: {dtype, shape, data_offsets}}``
    (and an optional ``__metadata__``), then the raw little-endian bytes;
    each tensor owns a copy of its bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which the reader does not "
                             f"map")
        start, end = info["data_offsets"]
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dtype)
        else:
            out[name] = torch.frombuffer(bytearray(data[start:end]),
                                         dtype=dtype).reshape(info["shape"])
    return out


def load_state(path) -> dict[str, torch.Tensor]:
    """A checkpoint file's tensors (``.safetensors``, or a torch
    ``.pth``/``.bin``, unwrapping a ``state_dict`` entry)."""
    if str(path).endswith(".safetensors"):
        return load_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def _resolve_checkpoint(name: str, dataset: str, checkpoint: Optional[str],
                        checkpoint_dir: Optional[str]) -> str:
    if checkpoint:
        return str(checkpoint)
    fname = f"{name}_{dataset}.pth"
    if checkpoint_dir:
        local = Path(checkpoint_dir) / fname
        if local.exists():
            return str(local)
    cache = Path(os.environ.get("LADI_VTON_CACHE",
                                Path.home() / ".cache" / "ladi_vton_tpu"))
    cache.mkdir(parents=True, exist_ok=True)
    target = cache / fname
    if not target.exists():
        url = f"{RELEASE_URL}/{fname}"
        print(f"downloading {url} -> {target}")
        urllib.request.urlretrieve(url, target)
    return str(target)


def _read_json(path: Path) -> Optional[dict]:
    if path.exists():
        with open(path) as f:
            return json.load(f)
    return None


def _sidecar_config(pth_path: str) -> Optional[dict]:
    """The ``<name>.config.json`` architecture next to a ``.pth``."""
    return _read_json(Path(pth_path).with_suffix(".config.json"))


def _dir_config(model_dir: str, subfolder: str) -> Optional[dict]:
    """A model directory's diffusers/transformers ``config.json``."""
    return _read_json(Path(model_dir) / subfolder / "config.json")


def _config_kwargs(cfg_cls, raw: dict) -> dict:
    """Keep only the keys the dataclass knows; tuple-ify sequences.  As in
    the JAX zoo, a diffusers ``attention_head_dim`` is not one of them:
    a diffusers SD-1.5 ``unet/config.json`` gets 64-wide heads, and the
    eight-head form comes from a sidecar's ``head_dim: -1``."""
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in raw.items() if k in fields}


def _find_model_file(model_dir: str, subfolder: str) -> Path:
    folder = Path(model_dir) / subfolder
    for fname in ("diffusion_pytorch_model.bin", "pytorch_model.bin",
                  "diffusion_pytorch_model.safetensors",
                  "model.safetensors"):
        path = folder / fname
        if path.exists():
            return path
    raise FileNotFoundError(f"no checkpoint under {folder}")


def widen_conv_in(state: dict, in_channels: int) -> dict:
    """The 9 -> N channel conv_in surgery: the file's input channels, then
    zeros, on the (O, I, kh, kw) weight; nothing when the file is already
    N wide."""
    w = state["conv_in.weight"]
    if w.shape[1] == in_channels:
        return state
    wide = w.new_zeros((w.shape[0], in_channels) + tuple(w.shape[2:]))
    wide[:, :w.shape[1]] = w
    return {**state, "conv_in.weight": wide}


def _with_batch_norm_counters(state: dict) -> dict:
    state = dict(state)
    for key in [k for k in state if k.endswith(".running_var")]:
        counter = key[:-len("running_var")] + "num_batches_tracked"
        state.setdefault(counter, torch.tensor(0, dtype=torch.long))
    return state


def _build(factory: Callable[[], torch.nn.Module], state: dict, *, dtype,
           device) -> torch.nn.Module:
    """``factory()`` on ``device`` in ``dtype``, loaded strictly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"zoo: asked for {device}, but CUDA is not "
                           f"available; pass device='cpu'")
    with torch.device(device):
        module = factory()
    # buffers a factory makes from numpy (TPS's kernels) ignore the
    # default device
    module.to(device)
    if dtype is not None:
        module.to(dtype)
    module.load_state_dict(state, strict=True)
    return module.eval()


def extended_unet(dataset: str = "vitonhd", *, checkpoint=None,
                  checkpoint_dir=None, dtype=torch.float32, device="cuda"):
    """The 31-channel SD-2 UNet with trained try-on weights (reference
    hubconf.py:30-37); a 9-channel file gets the conv_in surgery.  A
    ``.config.json`` sidecar overrides the architecture: one saying
    ``use_linear_projection: false`` and ``head_dim: -1`` builds the
    SD-1.5 UNet (1x1-conv projections, eight heads at every width)."""
    path = _resolve_checkpoint("unet", dataset, checkpoint, checkpoint_dir)
    side = _sidecar_config(path)
    cfg = (UNetConfig(**_config_kwargs(UNetConfig, side)) if side
           else sd2_unet_config(31))
    state = widen_conv_in(load_state(path), cfg.in_channels)
    return _build(lambda: UNet2DCondition(cfg), state, dtype=dtype,
                  device=device)


def emasc(dataset: str = "vitonhd", *, checkpoint=None, checkpoint_dir=None,
          dtype=torch.float32, device="cuda", kind: str = "nonlinear",
          kernel_size: int = 3):
    """EMASC with the reference channel plan (reference hubconf.py:40-53)
    or the sidecar's; ``kind`` and ``kernel_size`` from the caller."""
    path = _resolve_checkpoint("emasc", dataset, checkpoint, checkpoint_dir)
    side = _sidecar_config(path) or {}
    channels = {k: tuple(side[k]) for k in ("in_channels", "out_channels")
                if k in side}
    return _build(lambda: EMASC(kind=kind, kernel_size=kernel_size,
                                **channels),
                  load_state(path), dtype=dtype, device=device)


def inversion_adapter(dataset: str = "vitonhd", *, checkpoint=None,
                      checkpoint_dir=None, dtype=torch.float32,
                      device="cuda", num_encoder_layers: int = 1,
                      num_vstar: int = 16):
    """CLIP ViT-H/14 features -> ``num_vstar`` pseudo-word embeddings in
    SD-2 text space (reference hubconf.py:16-27)."""
    path = _resolve_checkpoint("inversion_adapter", dataset, checkpoint,
                               checkpoint_dir)
    side = _sidecar_config(path) or {}
    vc = (CLIPVisionConfig(**_config_kwargs(CLIPVisionConfig,
                                            side["vision_config"]))
          if "vision_config" in side else vit_h_vision_config())
    return _build(lambda: InversionAdapter(
        input_dim=side.get("input_dim", 1280),
        hidden_dim=side.get("hidden_dim", 1280 * 4),
        output_dim=side.get("output_dim", 1024 * num_vstar),
        num_encoder_layers=side.get("num_encoder_layers",
                                    num_encoder_layers),
        vision_config=vc), load_state(path), dtype=dtype, device=device)


def warping_module(dataset: str = "vitonhd", *, checkpoint=None,
                   checkpoint_dir=None, device="cuda"):
    """(ConvNetTPS, UNetVanilla refinement) from the reference's
    ``{"tps", "refinement"}`` bundle (reference hubconf.py:56-64), with
    their BatchNorm statistics; fp32, as the reference runs them."""
    path = _resolve_checkpoint("warping", dataset, checkpoint,
                               checkpoint_dir)
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    tps = _build(lambda: ConvNetTPS(height=256, width=192, input_nc_b=21),
                 _with_batch_norm_counters(bundle["tps"]), dtype=None,
                 device=device)
    refinement = _build(lambda: UNetVanilla(in_channels=24, out_channels=3),
                        _with_batch_norm_counters(bundle["refinement"]),
                        dtype=None, device=device)
    return tps, refinement


# ---------------------------------------------------------- SD-2 base towers


def _tower_state(path: Path, *, keep: str = "",
                 drop: tuple = ()) -> dict:
    state = load_state(path)
    return {k: v for k, v in state.items()
            if k.startswith(keep) and not k.endswith(".position_ids")
            and not any(k.startswith(d) for d in drop)}


def sd2_vae(model_dir: str, *, dtype=torch.float32, device="cuda"):
    """The EMASC-aware VAE with SD-2-inpainting weights (reference
    src/inference.py:126); architecture from ``vae/config.json``, SD-2
    otherwise."""
    raw = _dir_config(model_dir, "vae")
    cfg = VAEConfig(**_config_kwargs(VAEConfig, raw)) if raw else VAEConfig()
    return _build(lambda: AutoencoderKL(cfg),
                  load_state(_find_model_file(model_dir, "vae")),
                  dtype=dtype, device=device)


def sd2_unet(model_dir: str, *, in_channels: int = 9, dtype=torch.float32,
             device="cuda"):
    """The stock SD-2-inpainting UNet with its conv_in widened to
    ``in_channels`` (reference src/train_vto.py:259-277); architecture
    from ``unet/config.json``, SD-2 otherwise."""
    raw = _dir_config(model_dir, "unet")
    base = (UNetConfig(**_config_kwargs(UNetConfig, raw)) if raw
            else sd2_unet_config(9))
    cfg = dataclasses.replace(base, in_channels=in_channels)
    state = widen_conv_in(load_state(_find_model_file(model_dir, "unet")),
                          in_channels)
    return _build(lambda: UNet2DCondition(cfg), state, dtype=dtype,
                  device=device)


def sd2_text_encoder(model_dir: str, *, dtype=torch.float32, device="cuda"):
    """The SD-2 CLIP text encoder; architecture from
    ``text_encoder/config.json``, SD-2 otherwise."""
    raw = _dir_config(model_dir, "text_encoder")
    cfg = (CLIPTextConfig(**_config_kwargs(CLIPTextConfig, raw)) if raw
           else sd2_text_config())
    return _build(lambda: CLIPTextModel(cfg),
                  _tower_state(_find_model_file(model_dir, "text_encoder")),
                  dtype=dtype, device=device)


def clip_vision_config(model_dir: Optional[str]) -> CLIPVisionConfig:
    """The vision tower's architecture without its weights: from the
    directory's ``config.json`` (``vision_config`` nested, as a
    transformers CLIP checkout has it, or at the top level), ViT-H/14
    otherwise."""
    raw = _dir_config(model_dir, "") if model_dir else None
    if raw is None:
        return vit_h_vision_config()
    return CLIPVisionConfig(**_config_kwargs(
        CLIPVisionConfig, raw.get("vision_config", raw)))


def clip_vit_h_vision(model_dir: str, *, dtype=torch.float32,
                      device="cuda"):
    """The laion/CLIP-ViT-H-14 vision tower (reference
    src/inference.py:127)."""
    cfg = clip_vision_config(model_dir)
    state = _tower_state(_find_model_file(model_dir, ""),
                         keep="vision_model.",
                         drop=("vision_model.post_layernorm.",))
    return _build(lambda: CLIPVisionModel(cfg), state, dtype=dtype,
                  device=device)

