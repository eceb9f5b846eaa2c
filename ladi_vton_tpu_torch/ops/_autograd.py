"""What the kernel wrappers share to be differentiable.

The JAX package gives none of its Pallas kernels a backward kernel: each
is a ``jax.custom_vjp`` whose forward runs the kernel and whose backward
recomputes the op through its XLA oracle and differentiates that.  The
port does the same with one ``torch.autograd.Function`` per wrapper: its
forward launches the hand-written kernel exactly as the wrapper does
without a gradient, and saves the inputs; its backward recomputes the
plain ``*_ref`` under ``torch.enable_grad()`` and returns its gradients
(``recompute_grads``).

A wrapper goes through its Function only where that is needed
(``through_function``): an input needs a gradient, or autocast is on
for the inputs' device, in which case the Function's
``torch.amp.custom_fwd(cast_inputs=torch.bfloat16)`` hands the kernel
bf16 activations and weights (the kernels take nothing else) and the
gradients flow back through that cast to fp32 parameters.  Serving calls
neither and keeps the direct launch.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def through_function(*tensors: torch.Tensor) -> bool:
    """Whether a CUDA call must take the wrapper's autograd Function."""
    if tensors[0].is_cuda and torch.is_autocast_enabled("cuda"):
        return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def recompute_grads(ref: Callable, saved: Sequence[torch.Tensor],
                    needs: Sequence[bool], grad_out: torch.Tensor) -> tuple:
    """Gradients of ``ref(*saved)`` against ``grad_out`` for the inputs
    flagged in ``needs`` (None for the others), recomputed under
    ``torch.enable_grad()``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(bool(n))
                  for t, n in zip(saved, needs)]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return (None,) * len(inputs)
        out = ref(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)
