"""Checkpoint save/restore of a training state (PyTorch).

Counterpart of ``epropnp_tpu/utils/checkpoint.py``: one file holds the
state's ``state_dict()`` (parameters, BatchNorm statistics, the Monte Carlo
loss's EMA buffer, the step) and the optimizer's (``torch.save``). Writes
are atomic (a temporary file, then ``os.replace``), so a run stopped
mid-write leaves the previous checkpoint whole. ``filter_fn`` restores only
the top-level entries it selects (the reference's key-filtered
``load_model``, EPro-PnP-6DoF/lib/model.py:79-113).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch


def save_checkpoint(path: str, state) -> str:
    """``state``: a module with a ``tx`` optimizer (``sixdof.train.
    TrainState`` or ``det.train.DetTrainState``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + '.tmp'
    torch.save({'state': state.state_dict(),
                'optimizer': state.tx.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state,
                    filter_fn: Optional[Callable[[str], bool]] = None):
    """Restore ``state`` in place from ``path`` and return it.

    ``filter_fn(key)`` picks among the top-level entries ``'params'``
    (parameters), ``'batch_stats'`` (BatchNorm buffers), ``'mc_state'``
    (the 6DoF ``norm_factor``), ``'ema'`` (the Det ``ema_*`` buffers),
    ``'step'`` and ``'opt_state'``; None restores all of them.
    """
    data = torch.load(path, map_location='cpu', weights_only=True)
    keep = filter_fn or (lambda key: True)
    params = {n for n, _ in state.named_parameters()}

    def entry(name):
        if name in params:
            return 'params'
        if name == 'norm_factor':
            return 'mc_state'
        if name.startswith('ema_'):
            return 'ema'
        if name == 'step':
            return 'step'
        return 'batch_stats'

    current = state.state_dict()
    current.update({k: v for k, v in data['state'].items()
                    if keep(entry(k))})
    state.load_state_dict(current)
    if keep('opt_state'):
        state.tx.load_state_dict(data['optimizer'])
    return state
