"""The weight bridge from the JAX package's parameters to the port.

``state_dict_from_jax`` takes flax parameters flattened to
``{path tuple: numpy array}`` (``flax.traverse_util.flatten_dict``) and
returns a torch state dict under reference/diffusers keys: conv kernels
HWIO -> OIHW, dense kernels (in, out) -> (out, in), ``scale`` ->
``weight``.  It is a jax-free copy of the naming rules of
``ladi_vton_tpu/core/checkpoint.py export_torch_state``; the key maps
below mirror that module's ``*_torch_key_map`` functions; the VAE and
EMASC keys need no map (``key_map=None``), as their identity maps say.
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


def state_dict_from_jax(flat: dict, key_map: Optional[Callable[[str], str]]
                        = None) -> dict[str, torch.Tensor]:
    """Torch state dict from flattened flax parameters (numpy arrays).

    A leading ``"params"`` path element, as ``flatten_dict`` of a full
    variables dict yields, is dropped.
    """
    state = {}
    for path, arr in flat.items():
        path = tuple(path)
        if path and path[0] == "params":
            path = path[1:]
        key, value = _to_torch_key_value(path, np.asarray(arr))
        if key_map is not None:
            key = key_map(key)
        state[key] = torch.from_numpy(np.array(value, order="C"))
    return state
