"""Losses of the PyTorch port."""

from .monte_carlo_pose_loss import (  # noqa: F401
    MonteCarloPoseLossState,
    monte_carlo_pose_loss,
)
