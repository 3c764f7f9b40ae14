"""Losses of the PyTorch port."""

from .det_losses import (  # noqa: F401
    cosine_angle_loss,
    mvd_gaussian_mixture_nll_loss,
    sigmoid_focal_loss,
    smooth_l1_loss_mod,
    weight_reduce_loss,
)
from .monte_carlo_pose_loss import (  # noqa: F401
    MonteCarloPoseLossState,
    monte_carlo_pose_loss,
)
