"""The weight bridge from the JAX package's parameters to the port.

``state_dict_from_jax`` takes flax parameters flattened to
``{path tuple: numpy array}`` (``flax.traverse_util.flatten_dict``) and
returns a torch state dict under reference/diffusers keys: conv kernels
HWIO -> OIHW, dense kernels (in, out) -> (out, in), ``scale`` ->
``weight``.  It is a jax-free copy of the naming rules of
``ladi_vton_tpu/core/checkpoint.py export_torch_state``; the key maps
below mirror that module's ``*_torch_key_map`` functions; the VAE and
the nonlinear EMASC keys need no map (``key_map=None``), as their
identity maps say, and ``emasc_key_map("linear")`` gives the linear
EMASC the reference's names.

BatchNorm statistics travel in flax's ``batch_stats`` collection beside
``params``; both are merged into one state dict, and every BatchNorm gets
the ``num_batches_tracked`` counter (0) that torch's own state dicts
carry, so the towers load with ``strict=True``.

The trainers' side is below: ``CheckpointManager`` (the port's own
training checkpoints), the host generators' states, and
``export_module``, the reference-layout ``.pth`` exports that both
packages' zoos load.
"""

from __future__ import annotations

import json
import os
import random
import re
import shutil
import threading
from pathlib import Path
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


def emasc_key_map(kind: str = "nonlinear") -> Callable[[str], str]:
    """Exported flax EMASC keys -> the reference EMASC of ``kind``.  The
    export names every stage ``conv.<i>.0.*``; the reference's linear
    stage is a bare conv, ``conv.<i>.*`` (its nonlinear stages keep
    ``conv.<i>.0/2.*``)."""
    if kind == "nonlinear":
        return lambda key: key
    if kind == "linear":
        return lambda key: re.sub(r"^conv\.(\d+)\.0\.", r"conv.\1.", key)
    raise ValueError(f"EMASC kind {kind!r}")


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


# ------------------------------------------------- training checkpoints


class CheckpointManager:
    """Training checkpoints as ``checkpoint-{step}/`` directories, the
    counterpart of ``ladi_vton_tpu/core/checkpoint.py CheckpointManager``
    in the port's own format: each holds ``state.pt``, a ``torch.save`` of
    the dict the trainer gives (trainable state dicts, optimizer and
    schedule count, step, generator states), read back with
    ``weights_only=True``.  The JAX package's orbax directories are not
    read; the two packages share the ``.pth`` exports.

    A write goes to a hidden temporary directory that is renamed into
    place when complete, so a ``checkpoint-{step}`` directory is always
    whole; the last ``keep`` are kept.  ``async_save`` copies the state
    to host memory, returns, and writes on one background thread; the
    next save, ``wait`` and ``restore`` wait for it first.  Old
    checkpoints are collected only before a write starts and after it has
    finished, never counting the one in flight, so a crash mid-write
    still leaves ``keep`` finished checkpoints.
    """

    def __init__(self, directory, *, keep: int = 2, async_save: bool = False):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dirs(self) -> list:
        out = []
        for p in self.directory.iterdir():
            m = re.fullmatch(r"checkpoint-(\d+)", p.name)
            if m and p.is_dir():
                out.append((int(m.group(1)), p))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def _gc(self) -> None:
        dirs = self._step_dirs()
        for _, old in dirs[:max(0, len(dirs) - self.keep)]:
            shutil.rmtree(old, ignore_errors=True)

    def _write(self, step: int, state: dict) -> None:
        final = self.directory / f"checkpoint-{step}"
        tmp = self.directory / f".checkpoint-{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / "state.pt")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

    def _run(self, step: int, state: dict) -> None:
        try:
            self._write(step, state)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def save(self, step: int, state: dict) -> None:
        self.wait()
        if not self.async_save:
            self._write(step, state)
            self._gc()
            return
        snapshot = _to_host(state)
        self._thread = threading.Thread(target=self._run,
                                        args=(step, snapshot), daemon=False)
        self._thread.start()

    def wait(self) -> None:
        """Block until an in-flight write is on disk (raising its error),
        then collect old checkpoints."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._error is not None:
                error, self._error = self._error, None
                raise error
        self._gc()

    def restore(self, step="latest") -> dict:
        """The state dict of ``checkpoint-{step}`` (``"latest"``: the
        newest), on the CPU; FileNotFoundError where there is none."""
        self.wait()
        if step == "latest":
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        path = self.directory / f"checkpoint-{int(step)}" / "state.pt"
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint-{step} under "
                                    f"{self.directory}")
        return torch.load(path, map_location="cpu", weights_only=True)


def _to_host(tree):
    """A copy of ``tree`` whose tensors live in CPU memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def rng_state() -> dict:
    """The host generators' states (python, numpy, torch), in a form
    ``torch.load(weights_only=True)`` reads."""
    kind, keys, pos, has_gauss, cached = np.random.get_state()
    return {"python": random.getstate(), "torch": torch.get_rng_state(),
            "numpy": [kind, torch.from_numpy(keys.astype(np.int64)), pos,
                      has_gauss, cached]}


def set_rng_state(state: dict) -> None:
    kind, keys, pos, has_gauss, cached = state["numpy"]
    np.random.set_state((kind, keys.numpy().astype(np.uint32), pos,
                         has_gauss, cached))
    python = state["python"]
    random.setstate((python[0], tuple(python[1]), python[2]))
    torch.set_rng_state(state["torch"])


def export_module(module: torch.nn.Module, path,
                  config: Optional[dict] = None,
                  state: Optional[dict] = None) -> Path:
    """A tower's ``.pth`` in the reference layout (its state dict, or
    ``state`` where given, as a tensor-parallel module's gathered one; on
    the CPU, fp32 where floating), written atomically, with the
    architecture as a ``.config.json`` sidecar the zoos read."""
    path = Path(path)
    state = module.state_dict() if state is None else state
    state = {k: (v.detach().float() if v.is_floating_point() else v.detach()
                 ).cpu().clone() for k, v in state.items()}
    save_atomic(state, path)
    if config is not None:
        path.with_suffix(".config.json").write_text(json.dumps(config))
    return path


def save_atomic(obj, path) -> None:
    """``torch.save`` to a temporary file beside ``path``, then rename."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)
