"""torch.hub entry points of the PyTorch port.

The reference's four loadable models by the same names (reference
hubconf.py:16-64), each returning the port's torch modules, built by
``ladi_vton_tpu_torch.hub.zoo``:

    torch.hub.load("<repo>/ladi_vton_tpu_torch", "extended_unet",
                   source="local", checkpoint_dir="<dir of the .pth files>")

Keyword arguments go to the zoo loader (``checkpoint``,
``checkpoint_dir``, ``dtype``, ``device``; ``kind`` and ``kernel_size``
for the EMASC).  Modules go to ``device="cuda"`` unless the caller asks
for ``"cpu"``.  The repository root's ``hubconf.py`` serves the JAX
package.
"""

import os
import sys

dependencies = ["torch", "numpy"]

# torch.hub puts this directory, not the repository root, on sys.path
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.append(_ROOT)

from ladi_vton_tpu_torch.hub import zoo  # noqa: E402


def inversion_adapter(dataset: str = "vitonhd", **kwargs):
    """CLIP ViT-H/14 features -> 16 pseudo-word token embeddings in SD-2
    text space (reference hubconf.py:16-27)."""
    return zoo.inversion_adapter(dataset, **kwargs)


def extended_unet(dataset: str = "vitonhd", **kwargs):
    """The 31-input-channel SD-2-inpainting UNet with trained try-on
    weights (reference hubconf.py:30-37)."""
    return zoo.extended_unet(dataset, **kwargs)


def emasc(dataset: str = "vitonhd", **kwargs):
    """EMASC with the reference channel plan (reference
    hubconf.py:40-53)."""
    return zoo.emasc(dataset, **kwargs)


def warping_module(dataset: str = "vitonhd", **kwargs):
    """(ConvNetTPS, UNetVanilla refinement) with trained warping weights
    (reference hubconf.py:56-64)."""
    return zoo.warping_module(dataset, **kwargs)
