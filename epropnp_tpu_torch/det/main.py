"""Det-suite training driver (PyTorch), counterpart of the single-device
half of ``epropnp_tpu/det/main.py``: build the detector, the optimizer and
the train step, iterate batches, checkpoint per epoch (and resume), and
the class-balanced sampler ``CBGSWrapper``. One device; it is the CUDA
card unless the caller passes another. Training may start from a torch
checkpoint (``load_torch``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import get_logger
from . import train as dtrain
from .api import build_detector, load_torch_weights
from .config import DetConfig


def _device(device) -> torch.device:
    return torch.device('cuda' if device is None else device)


def build_all(cfg: DetConfig, device=None, seed: int = 0):
    """The detector on ``device`` (channels-last weights), its parameters
    the layers' initialisers drawn from ``seed``, and the train step.
    Returns ``(model, step_fn)``."""
    if (cfg.bf16_backbone or cfg.bf16_dense or cfg.int8_dcn_gather
            or cfg.level_packed_towers or cfg.remat_dense):
        raise NotImplementedError(
            'training with bf16_backbone, bf16_dense, int8_dcn_gather, '
            'level_packed_towers or remat_dense is not ported')
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_detector(cfg)
    model = model.to(_device(device), memory_format=torch.channels_last)
    return model, dtrain.make_train_step(cfg)


def init_state(cfg: DetConfig, model, steps_per_epoch: int = 0
               ) -> dtrain.DetTrainState:
    """The optimizer (``make_optimizer``) and the EMA buffers at 1 around
    ``model``."""
    tx = dtrain.make_optimizer(cfg, model, steps_per_epoch)
    return dtrain.DetTrainState(model, tx)


_INT_FIELDS = {'gt_labels', 'gt_attr'}
_BOOL_FIELDS = {'img_flips', 'gt_mask', 'gt_pts_mask'}


def to_device(batch, device, dtype=torch.float32) -> dtrain.DetBatch:
    """A ``DetBatch`` of numpy arrays or tensors -> tensors on ``device``:
    labels int64, masks and flips bool, the rest ``dtype``."""
    out = {}
    for name, a in zip(dtrain.DetBatch._fields, batch):
        if a is None:
            out[name] = None
            continue
        t = torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a)
        if name in _INT_FIELDS:
            t = t.long()
        elif name in _BOOL_FIELDS:
            t = t.bool()
        else:
            t = t.to(dtype)
        out[name] = t.to(device)
    return dtrain.DetBatch(**out)


def train_loop(cfg: DetConfig, batch_iter_factory, steps_per_epoch: int,
               save_dir: str, resume_from: Optional[str] = None,
               log_interval: int = 50, seed: int = 0,
               ckpt_interval: int = 1, eval_fn=None, eval_interval: int = 1,
               device=None, on_step: Optional[Callable] = None,
               load_torch: Optional[str] = None):
    """``batch_iter_factory(epoch)`` -> an iterator of ``DetBatch`` records
    (numpy arrays or tensors), ``cfg.train.epochs`` epochs.

    Checkpoints ``checkpoint_{epoch:03d}.pt`` and ``latest.pt`` every
    ``ckpt_interval`` epochs and after the last; ``resume_from`` restores a
    whole state. ``eval_fn(state, epoch) -> dict`` runs every
    ``eval_interval`` epochs after the checkpoint, and its scalar metrics
    are logged. ``on_step(epoch, i, metrics)``, when given, is called after
    every step with the step's metrics (tensors on the device).
    ``load_torch`` grafts a torch checkpoint (a torchvision ImageNet
    backbone, an mmdet backbone and neck, or a full EProPnPDet file;
    ``api.load_torch_weights``) onto the fresh weights before training, as
    the reference starts from ``init_cfg=Pretrained torchvision://resnet101``
    (configs/epropnp_det_basic.py:18). Returns the state.
    """
    device = _device(device)
    logger = get_logger('epropnp_tpu_torch.det', save_dir)
    model, step_fn = build_all(cfg, device, seed)
    if load_torch:
        load_torch_weights(model, cfg, load_torch)
        logger.info('grafted torch weights from %s', load_torch)
    state = init_state(cfg, model, steps_per_epoch)
    if resume_from:
        load_checkpoint(resume_from, state)
        logger.info('resumed from %s', resume_from)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    for epoch in range(cfg.train.epochs):
        t0 = time.time()
        for i, batch in enumerate(batch_iter_factory(epoch)):
            metrics = step_fn(state, to_device(batch, device), gen)
            if on_step is not None:
                on_step(epoch, i, metrics)
            if i % log_interval == 0:
                logger.info('epoch %d iter %d/%d: %s (%.1fs)', epoch, i,
                            steps_per_epoch, ' '.join(
                                f'{k}={float(v):.4f}'
                                for k, v in sorted(metrics.items())),
                            time.time() - t0)
        if (epoch + 1) % ckpt_interval == 0 \
                or epoch + 1 == cfg.train.epochs:
            save_checkpoint(
                os.path.join(save_dir, f'checkpoint_{epoch:03d}.pt'), state)
            save_checkpoint(os.path.join(save_dir, 'latest.pt'), state)
        if eval_fn is not None and (epoch + 1) % eval_interval == 0:
            metrics = eval_fn(state, epoch)
            logger.info('epoch %d eval: %s', epoch, ' '.join(
                f'{k}={v:.4f}' for k, v in sorted(metrics.items())
                if isinstance(v, (int, float))))
        logger.info('epoch %d done', epoch)
    return state


class CBGSWrapper:
    """Class-balanced group sampling (a copy of the JAX package's, the
    reference's dataset_wrappers.py:12): sample indices are duplicated so
    that every class appears with near-uniform frequency."""

    def __init__(self, dataset, sample_classes):
        """``sample_classes[i]``: the class ids in sample i."""
        self.dataset = dataset
        num_classes = max((max(c, default=0) for c in sample_classes),
                          default=0) + 1
        cls_to_samples = [[] for _ in range(num_classes)]
        for i, cls_set in enumerate(sample_classes):
            for c in set(cls_set):
                cls_to_samples[c].append(i)
        counts = np.array([max(len(s), 1) for s in cls_to_samples])
        frac = 1.0 / num_classes
        ratios = frac / (counts / counts.sum())
        indices = []
        for c, samples in enumerate(cls_to_samples):
            n_take = int(len(samples) * ratios[c])
            if samples:
                indices += list(np.random.default_rng(c).choice(
                    samples, n_take, replace=True))
        self.indices = indices or list(range(len(dataset)))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]
