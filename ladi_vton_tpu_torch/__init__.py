"""PyTorch and CUDA port of ``ladi_vton_tpu`` for NVIDIA Hopper (H100).

Sub-packages mirror the JAX package (``ops``, ``models``, ``diffusion``,
``pipelines``, ``core``, ``hub``, ``utils``, ``data``, ``cli``);
``hubconf.py`` holds the torch.hub entry points.  The port imports
``torch`` and never JAX, PIL or cv2; the kernels the JAX package wrote in
Pallas are hand-written CUDA under ``csrc/``, built at first use
(``ops._build``), and the data layer's host C++ is under ``csrc/host/``
(``data.native``).
"""
