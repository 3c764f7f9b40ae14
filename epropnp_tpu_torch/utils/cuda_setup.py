"""The process-wide CUDA settings under which the port is measured and
checked: every CLI of the port and ``chip_smoke.py`` call
:func:`configure_cuda` first, so a user of the CLIs runs what the smoke run
held against the CPU. Library functions (``init_detector``,
``train_loop``) set no global state.
"""

from __future__ import annotations

import torch


def configure_cuda() -> None:
    """TF32 off for cuDNN and for matmul (the convolutions and products
    keep full f32 inputs, as the card-vs-CPU checks assume), and cuDNN's
    exhaustive algorithm search for every convolution
    (``benchmark = True``, ``benchmark_limit = 0``). Call it before the
    first convolution: PyTorch caches the algorithm per shape. cuDNN's
    default f32 heuristics run several 3x3 convolutions of the Det model
    at a batch of 6 frames as FFT tiling, up to ~400 ms a call against
    ~1 ms for the algorithm the search finds. Harmless on a machine
    without CUDA."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.benchmark_limit = 0
