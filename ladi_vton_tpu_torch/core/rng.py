"""Seeds for the port's drivers and services.

Counterpart of ``ladi_vton_tpu/core/rng.py``.  The JAX package draws a
batch's noise from ``jax.random.fold_in(root_key, step)``; the port draws
it from an explicit ``torch.Generator`` on the batch's device seeded with
``request_seed(seed, step)``, so a batch's images depend only on the
seed and its index.  The two streams differ: the same seed gives other
noise than in the JAX package (a documented departure, as in the
services).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed the host's generators (python, numpy, torch)."""
    random.seed(seed)
    np.random.seed(seed % 2 ** 32)
    torch.manual_seed(seed)


def request_seed(seed: int, count: int) -> int:
    """A 63-bit generator seed derived from (seed, request or batch)."""
    state = np.random.SeedSequence([seed, count]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def batch_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of batch ``step``'s draws, on ``device``."""
    return torch.Generator(torch.device(device)).manual_seed(
        request_seed(seed, step))
