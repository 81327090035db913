"""PyTorch/CUDA port of the DALI reproduction (the JAX package ``repro``
is the reference it is tested against).

The port imports ``torch`` and ``numpy`` only: never ``jax`` and never a
module of ``repro``.  Module layout mirrors ``repro`` so each module's
counterpart is found under the same path.  The TPU kernels of ``repro``
are hand-written CUDA C++ for Hopper here (``csrc/``), built at first use
into ``build/kernels/`` and bound through ``ctypes``
(``repro_torch.kernels``).
"""
