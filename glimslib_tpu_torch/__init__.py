"""GlimSLib in PyTorch: the port of ``glimslib_tpu`` to PyTorch and CUDA.

Module paths mirror ``glimslib_tpu/``.  This first slice runs the lattice
forward step of :class:`~glimslib_tpu_torch.models.tumor_growth_brain.TumorGrowthBrain`
end to end: offset-stencil operators (``ops/stencil.py``), stencil matvecs
and whole-solve PCG as hand-written CUDA kernels for Hopper
(``csrc/stencil.cu``, bound in ``ops/stencil_kernels.py`` and
``ops/fused_cg.py``), block-triangular Newton-CG (``solvers/coupled.py``)
and the implicit-Euler time loop (``models/base.py``).  Everything outside
the slice raises ``NotImplementedError``.

The package imports ``torch`` and never ``jax``.
"""

from glimslib_tpu_torch import config

__version__ = "0.1.0"

__all__ = ["config", "__version__"]
