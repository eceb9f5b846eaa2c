"""Precomputed CLIP cloth-feature cache.

The port's copy of ``ladi_vton_tpu/data/features.py``.

The reference caches CLIP ViT last_hidden_states for every in-shop
garment as one big torch tensor + a name pickle
(reference: src/utils/compute_cloth_clip_features.py:143-166,
src/dataset/dresscode.py:97-104).  This cache stores numpy ``.npz``
shards (names + features) written by
the JAX package's ``cli.compute_cloth_clip_features`` and also reads the
reference's torch ``.pt``/``.pkl`` layout when present, so existing
caches convert for free.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch


class ClothFeatureCache:
    def __init__(self, root: str | Path, phase: str):
        self.root = Path(root)
        self.phase = phase
        self._names: list[str] = []
        self._feats: np.ndarray | None = None
        self._index: dict[str, int] = {}
        self._load()

    def _load(self):
        npz = self.root / f"{self.phase}_features.npz"
        pt = self.root / f"{self.phase}_last_hidden_state_features.pt"
        pkl = self.root / f"{self.phase}_features_names.pkl"
        if npz.exists():
            data = np.load(npz, allow_pickle=False)
            self._feats = data["features"]
            self._names = [str(n) for n in data["names"]]
        elif pt.exists() and pkl.exists():
            self._feats = torch.load(pt, map_location="cpu").float().numpy()
            with open(pkl, "rb") as f:
                self._names = pickle.load(f)
        else:
            raise FileNotFoundError(
                f"no CLIP cloth feature cache under {self.root} "
                f"(expected {npz.name} or {pt.name}+{pkl.name})")
        self._index = {n: i for i, n in enumerate(self._names)}

    def get(self, c_name: str) -> np.ndarray:
        return np.asarray(self._feats[self._index[c_name]], np.float32)

    @staticmethod
    def write(root: str | Path, phase: str, names: list[str],
              features: np.ndarray):
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        np.savez(root / f"{phase}_features.npz",
                 names=np.asarray(names), features=features)
