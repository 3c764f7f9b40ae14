"""PyTorch/CUDA port of epropnp-tpu (EPro-PnP).

The JAX package ``epropnp_tpu`` is the reference; this package mirrors its
layout (``epropnp_tpu/X/y.py`` -> ``epropnp_tpu_torch/X/y.py``) and keeps
its public layouts: NHWC images and dense maps, ``(B, N, 3|2)`` point sets
and the ``[x, y, z, w, i, j, k]`` pose. It imports neither ``jax`` nor
``epropnp_tpu``. Its kernels (K1 and K2 for the PnP solve, K3 for the DCN
sampling contraction) are hand-written CUDA for ``sm_90a`` (``csrc/``),
built with ``nvcc`` at first use (``kernels.py``).
"""

from .ops.pnp import (  # noqa: F401
    AdaptiveHuberPnPCost,
    HuberPnPCost,
    LMSolver,
    PerspectiveCamera,
    RSLMSolver,
    evaluate_pnp,
)
from .models.cdpn import CDPN, CDPNOutputs  # noqa: F401
