"""Test problems (host-side generators), counterparts of
``hpddm_tpu/models``: ``diffusion2d``, ``diffusion3d``, ``elasticity2d``,
``elasticity3d``, ``fromfile``, ``helmholtz``, ``nonoverlap``,
``sequences``, ``stokes2d`` and ``unstructured``."""
