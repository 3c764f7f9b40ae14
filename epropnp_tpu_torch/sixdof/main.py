"""6DoF suite training driver (PyTorch).

Counterpart of the training half of ``epropnp_tpu/sixdof/main.py`` (the
reference CLI entry, EPro-PnP-6DoF/tools/main.py:44-106): build the model,
the PnP stack, the optimizer and the train step, then the epoch loop with
the step decay inside the optimizer and a checkpoint per
``ckpt_interval`` epochs. One device; it is the CUDA card unless the
caller passes another.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.cdpn import CDPN
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import get_logger
from ..utils.meters import AverageMeter
from . import train as train_lib
from .config import SixDoFConfig

# LineMOD's camera (epropnp_tpu/sixdof/ref_constants.py, from the
# reference's lib/ref.py)
CAMERA_MATRIX = ((572.4114, 0.0, 325.2611), (0.0, 573.57043, 242.04899),
                 (0.0, 0.0, 1.0))


def _device(device) -> torch.device:
    return torch.device('cuda' if device is None else device)


def build_all(cfg: SixDoFConfig, cam_intrinsic=None, device=None):
    """Model (on ``device``), PnP stack and train step.

    Returns ``(model, epropnp, step_fn)``; the optimizer needs the model's
    parameters and comes with the state (:func:`init_state`).
    """
    net = cfg.network
    if net.bf16_backbone or net.remat:
        raise NotImplementedError(
            'bf16_backbone and remat training are not ported')
    device = _device(device)
    feat = cfg.dataiter.inp_res // 32
    model = CDPN(depth=net.back_layers_num, feat_hw=(feat, feat)).to(device)
    epropnp = train_lib.build_epropnp(cfg)
    cam = torch.tensor(CAMERA_MATRIX if cam_intrinsic is None
                       else cam_intrinsic, dtype=torch.float32,
                       device=device)
    step_fn = train_lib.make_train_step(epropnp, cfg, cam)
    return model, epropnp, step_fn


def init_state(cfg: SixDoFConfig, model: CDPN, steps_per_epoch: int = 1,
               seed: int = 0) -> train_lib.TrainState:
    """Fresh parameters from ``seed`` (the layers' default initialisers),
    default BatchNorm statistics, the optimizer, ``norm_factor`` 1."""
    devices = [model.backbone.conv1.weight.device]
    with torch.random.fork_rng(devices=[d for d in devices
                                        if d.type == 'cuda']):
        torch.manual_seed(seed)
        for mod in model.modules():
            if hasattr(mod, 'reset_parameters'):
                mod.reset_parameters()
    tx = train_lib.make_optimizer(cfg, model, steps_per_epoch)
    return train_lib.TrainState(model, tx)


def to_device(batch, device) -> train_lib.Batch:
    """A batch of numpy arrays or tensors -> float32 tensors on ``device``."""
    return train_lib.Batch(*(torch.as_tensor(np.asarray(a) if not isinstance(
        a, torch.Tensor) else a, dtype=torch.float32).to(device)
        for a in batch))


def train_loop(cfg: SixDoFConfig, dataset, save_dir: str,
               resume_from: Optional[str] = None, log_interval: int = 20,
               seed: int = 0, ckpt_interval: int = 1, device=None,
               on_step: Optional[Callable] = None):
    """Epoch loop over ``dataset``, any object with ``__len__`` and
    ``batches(batch_size, shuffle, seed)`` yielding ``Batch`` records of
    numpy arrays or tensors.

    ``on_step(epoch, i, metrics)``, when given, is called after every step
    with the step's metrics (tensors on the device). Returns the state.
    """
    device = _device(device)
    logger = get_logger('epropnp_tpu_torch.6dof', save_dir)
    n_batches = max(len(dataset) // cfg.train.train_batch_size, 1)
    model, _, step_fn = build_all(cfg, device=device)
    state = init_state(cfg, model, n_batches, seed)
    if cfg.load_model:
        load_checkpoint(cfg.load_model, state,
                        filter_fn=lambda k: k == 'params')
        logger.info('loaded params from %s', cfg.load_model)
    if resume_from:
        load_checkpoint(resume_from, state)
        logger.info('resumed full state from %s', resume_from)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)

    for epoch in range(cfg.train.begin_epoch, cfg.train.end_epoch):
        meters = {}
        t0 = time.time()
        batches = dataset.batches(cfg.train.train_batch_size, shuffle=True,
                                  seed=seed + epoch)
        for i, batch in enumerate(batches):
            metrics = step_fn(state, to_device(batch, device), gen)
            if on_step is not None:
                on_step(epoch, i, metrics)
            if i % log_interval == 0:
                for name, v in metrics.items():
                    meters.setdefault(name, AverageMeter()).update(
                        float(v))
                logger.info(
                    'epoch %d iter %d/%d: %s (%.1fs)', epoch, i, n_batches,
                    ' '.join(f'{n}={mt.val:.4f}'
                             for n, mt in meters.items()),
                    time.time() - t0)
        if (epoch + 1) % ckpt_interval == 0 \
                or epoch + 1 == cfg.train.end_epoch:
            ckpt = os.path.join(save_dir, f'checkpoint_{epoch:03d}.pt')
            save_checkpoint(ckpt, state)
            save_checkpoint(os.path.join(save_dir, 'latest.pt'), state)
            logger.info('epoch %d done, checkpoint -> %s', epoch, ckpt)
        else:
            logger.info('epoch %d done', epoch)
    return state
