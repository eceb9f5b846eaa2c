"""PyTorch and CUDA port of ``ladi_vton_tpu`` for NVIDIA Hopper (H100).

Sub-packages mirror the JAX package (``ops``, ``models``, ``diffusion``,
``pipelines``, ``core``, ``hub``, ``utils``); ``hubconf.py`` holds the
torch.hub entry points.  The port imports ``torch`` and never JAX; the
kernels the JAX package wrote in Pallas are hand-written CUDA under
``csrc/``, built at first use (``ops._build``).
"""
