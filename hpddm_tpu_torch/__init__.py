"""hpddm_tpu_torch: the PyTorch/CUDA port of hpddm_tpu.

The same batched layout as the JAX package (the subdomain axis ``S``
leads; vectors are (S, n_max, mu)), held against it by the tests in
``tests/test_torch_*.py``. Host setup is numpy/scipy, the runtime is
plain PyTorch, and the kernels of the Krylov hot loop are hand-written
CUDA (``csrc/*.cu``, built at first use by ``_build.py``): the DIA SpMV of
stencil operators, the ELL SpMV of unstructured ones and the one-pass
exchange that goes with them. Entry points put their tensors on the card
unless the caller asks for the CPU. Module paths mirror ``hpddm_tpu``.
This package never imports JAX.
"""

__version__ = "0.1.0"

from hpddm_tpu_torch.core.csr import MatrixCSR
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.precond.schwarz import Schwarz
from hpddm_tpu_torch.solvers.krylov import solve

__all__ = ["Options", "MatrixCSR", "Decomposition", "Schwarz", "solve",
           "__version__"]
