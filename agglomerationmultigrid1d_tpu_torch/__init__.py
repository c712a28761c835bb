"""agglomerationmultigrid1d_tpu_torch — the PyTorch / CUDA port of
``agglomerationmultigrid1d_tpu``.

It mirrors the JAX package's subpackages and function names for the
DG-topped block-tridiagonal multigrid chain: setup on the host in float64,
the V-cycle and its drivers as eager tensor code, and the V-cycle's hot
kernels hand-written in CUDA for Hopper (``csrc/``, bound in
``ops/kernels/``), and the element-sharded solve over ``torch.distributed``
(``parallel/``).  It never imports JAX.

Float32 matrix products must stay full float32: the coarse solve and the
setup contractions feed solves to 1e-10 relative residual, and TF32 keeps
about three decimal digits (the counterpart of the JAX package's
``jax_default_matmul_precision="highest"``).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import numerics, mesh, ops, assembly, transfer, smoothers, models, utils, parallel  # noqa: E402,F401

__version__ = "0.1.0"
