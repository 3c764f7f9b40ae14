"""Probabilistic PnP core in PyTorch: geometry, cost, LM/RSLM solvers.

Counterpart of ``epropnp_tpu/ops/pnp``. The fused solves run through the
hand-written CUDA kernels of ``lm_kernel`` (K1) and ``rslm_kernel`` (K2)
on CUDA tensors, and through their plain torch twins on CPU tensors.
"""

from .common import (  # noqa: F401
    evaluate_pnp,
    pnp_denormalize,
    pnp_normalize,
    pose_to_rot_mat,
    quaternion_to_rot_mat,
    skew,
    yaw_to_rot_mat,
)
from .camera import PerspectiveCamera  # noqa: F401
from .cost_fun import AdaptiveHuberPnPCost, HuberPnPCost, huber_kernel  # noqa: F401
from .levenberg_marquardt import LMSolver, RSLMSolver  # noqa: F401
from .epropnp import EProPnP4DoF, EProPnP6DoF, EProPnPBase  # noqa: F401
from .distributions import (  # noqa: F401
    AngularCentralGaussian,
    MultivariateStudentT,
    VonMisesUniformMix,
    cholesky_wrapper,
)
