"""The weight bridge from the JAX package's parameters to the port.

``state_dict_from_jax`` takes flax parameters flattened to
``{path tuple: numpy array}`` (``flax.traverse_util.flatten_dict``) and
returns a torch state dict under reference/diffusers keys: conv kernels
HWIO -> OIHW, dense kernels (in, out) -> (out, in), ``scale`` ->
``weight``.  It is a jax-free copy of the naming rules of
``ladi_vton_tpu/core/checkpoint.py export_torch_state``; the key maps
below mirror that module's ``*_torch_key_map`` functions; the VAE and
EMASC keys need no map (``key_map=None``), as their identity maps say.

BatchNorm statistics travel in flax's ``batch_stats`` collection beside
``params``; both are merged into one state dict, and every BatchNorm gets
the ``num_batches_tracked`` counter (0) that torch's own state dicts
carry, so the towers load with ``strict=True``.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np
import torch


def _to_torch_key_value(path: tuple, arr: np.ndarray):
    parts = []
    for p in path[:-1]:
        # resnets_0 -> resnets.0 ; conv_0_2 -> conv.0.2
        parts.extend(re.sub(r"_(\d+)", r".\1", p).split("."))
    leaf = path[-1]
    key = ".".join(parts)
    dot = key + "." if key else ""
    if leaf == "kernel":
        if arr.ndim == 4:  # conv HWIO -> OIHW
            return dot + "weight", np.transpose(arr, (3, 2, 0, 1))
        return dot + "weight", arr.T  # dense (in, out) -> (out, in)
    if leaf in ("scale", "embedding"):
        return dot + "weight", arr
    if leaf in ("mean", "var"):
        return dot + {"mean": "running_mean", "var": "running_var"}[leaf], arr
    return dot + leaf, arr


def unet_key_map(key: str) -> str:
    """Exported flax UNet keys -> diffusers' UNet2DConditionModel keys."""
    key = re.sub(r"\.to_out\.(weight|bias)$", r".to_out.0.\1", key)
    key = re.sub(r"\.ff\.proj_geglu\.", ".ff.net.0.proj.", key)
    key = re.sub(r"\.ff\.proj_out\.", ".ff.net.2.", key)
    key = key.replace("time_embedding.linear.1.", "time_embedding.linear_1.")
    return key.replace("time_embedding.linear.2.", "time_embedding.linear_2.")


def clip_text_key_map(key: str) -> str:
    """Exported flax CLIP text keys -> transformers' CLIPTextModel."""
    key = re.sub(r"^token_embedding\.",
                 "text_model.embeddings.token_embedding.", key)
    key = re.sub(r"^position_embedding\.",
                 "text_model.embeddings.position_embedding.", key)
    key = re.sub(r"^layers\.(\d+)\.", r"text_model.encoder.layers.\1.", key)
    key = re.sub(r"^final_layer_norm\.", "text_model.final_layer_norm.",
                 key)
    return key.replace(".mlp_fc1.", ".mlp.fc1.").replace(".mlp_fc2.",
                                                         ".mlp.fc2.")


def clip_vision_key_map(key: str) -> str:
    """Exported flax CLIP vision keys -> transformers' CLIPVisionModel."""
    key = re.sub(r"^class_embedding",
                 "vision_model.embeddings.class_embedding", key)
    key = re.sub(r"^patch_embedding\.",
                 "vision_model.embeddings.patch_embedding.", key)
    key = re.sub(r"^position_embedding\.",
                 "vision_model.embeddings.position_embedding.", key)
    key = re.sub(r"^pre_layrnorm\.", "vision_model.pre_layrnorm.", key)
    key = re.sub(r"^layers\.(\d+)\.", r"vision_model.encoder.layers.\1.",
                 key)
    return key.replace(".mlp_fc1.", ".mlp.fc1.").replace(".mlp_fc2.",
                                                         ".mlp.fc2.")


def inversion_adapter_key_map(key: str) -> str:
    """Exported adapter keys -> the reference InversionAdapter
    (``encoder_layers.N``, ``post_layernorm``, ``layers.N``)."""
    return key.replace(".mlp_fc1.", ".mlp.fc1.").replace(".mlp_fc2.",
                                                         ".mlp.fc2.")


_TPS_EXT_CONVS = {0: 0, 1: 3, 2: 6, 3: 9, 4: 12, 5: 15}
_TPS_EXT_BNS = {0: 2, 1: 5, 2: 8, 3: 11, 4: 14}
_TPS_REG_CONVS = {0: 0, 1: 3, 2: 6, 3: 9}
_TPS_REG_BNS = {0: 1, 1: 4, 2: 7, 3: 10}


def tps_key_map(key: str) -> str:
    """Exported ConvNetTPS keys -> the reference ConvNet_TPS Sequential
    indices."""
    m = re.match(r"(extraction[AB])\.(conv|bn)\.(\d+)\.(.*)", key)
    if m:
        name, kind, i, rest = m.groups()
        idx = (_TPS_EXT_CONVS if kind == "conv" else _TPS_EXT_BNS)[int(i)]
        return f"{name}.model.{idx}.{rest}"
    m = re.match(r"regression\.(conv|bn)\.(\d+)\.(.*)", key)
    if m:
        kind, i, rest = m.groups()
        idx = (_TPS_REG_CONVS if kind == "conv" else _TPS_REG_BNS)[int(i)]
        return f"loc_net.regression.conv.{idx}.{rest}"
    if key.startswith("regression.linear"):
        return key.replace("regression.linear", "loc_net.regression.linear")
    return key


def refinement_key_map(key: str) -> str:
    """Exported UNetVanilla keys -> the reference unet_parts layout
    (double_conv indices 0/1/3/4, ``downK.maxpool_conv.1``, ``upK.conv``,
    ``outc.conv``)."""
    m = re.match(r"(inc|down\d|up\d)\.(conv|bn)\.(\d)\.(.*)", key)
    if m:
        mod, kind, i, rest = m.groups()
        idx = ({0: 0, 1: 3} if kind == "conv" else {0: 1, 1: 4})[int(i)]
        if mod == "inc":
            prefix = "inc.double_conv"
        elif mod.startswith("down"):
            prefix = f"{mod}.maxpool_conv.1.double_conv"
        else:
            prefix = f"{mod}.conv.double_conv"
        return f"{prefix}.{idx}.{rest}"
    if key.startswith("outc."):
        return key.replace("outc.", "outc.conv.")
    return key


def state_dict_from_jax(flat: dict, key_map: Optional[Callable[[str], str]]
                        = None) -> dict[str, torch.Tensor]:
    """Torch state dict from flattened flax variables (numpy arrays).

    A leading ``"params"`` or ``"batch_stats"`` path element, as
    ``flatten_dict`` of a full variables dict yields, is dropped; the two
    collections merge.  Each BatchNorm (a ``running_var`` key) also gets
    ``num_batches_tracked`` = 0.
    """
    state = {}
    for path, arr in flat.items():
        path = tuple(path)
        if path and path[0] in ("params", "batch_stats"):
            path = path[1:]
        key, value = _to_torch_key_value(path, np.asarray(arr))
        if key_map is not None:
            key = key_map(key)
        state[key] = torch.from_numpy(np.array(value, order="C"))
    for key in [k for k in state if k.endswith(".running_var")]:
        state[key[:-len("running_var")] + "num_batches_tracked"] = (
            torch.tensor(0, dtype=torch.long))
    return state
