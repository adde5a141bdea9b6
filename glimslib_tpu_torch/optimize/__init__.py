from glimslib_tpu_torch.optimize.adjoint import InverseProblem, thresh
from glimslib_tpu_torch.optimize.lbfgsb import OptimizationProgress, minimize_lbfgsb

__all__ = ["InverseProblem", "thresh", "minimize_lbfgsb", "OptimizationProgress"]
