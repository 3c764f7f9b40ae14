"""6DoF suite training and evaluation loops (PyTorch).

Counterpart of ``epropnp_tpu/sixdof/main.py`` (the reference CLI entry,
EPro-PnP-6DoF/tools/main.py:44-106): build the model, the PnP stack, the
optimizer and the train step, then the epoch loop with the step decay
inside the optimizer and a checkpoint per ``ckpt_interval`` epochs
(``train_loop``, on one device or data-parallel over a
``torch.distributed`` group); evaluate a trained model on a test split
with ``PoseEvaluator``'s metrics (``test_loop``, the reference
lib/test.py). The device is the CUDA card unless the caller passes
another.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.cdpn import CDPN
from ..parallel import mesh
from ..parallel.prefetch import BackgroundIterator, prefetch_to_device
from ..utils.checkpoint import (TORCH_SUFFIXES, load_checkpoint,
                                load_jax_variables, save_checkpoint)
from ..utils.convert import cdpn_state_dict
from ..utils.logging import get_logger
from ..utils.meters import AverageMeter
from . import ref_constants as ref
from . import train as train_lib
from .config import SixDoFConfig


def _device(device) -> torch.device:
    return torch.device('cuda' if device is None else device)


def build_cdpn(cfg: SixDoFConfig) -> CDPN:
    """The CDPN of ``cfg`` on the CPU: ``network.back_layers_num``, the
    trans head's width from ``dataiter.inp_res``, and the backbone in bf16
    with ``network.bf16_backbone`` (JAX ``sixdof/main.py:31-34``)."""
    feat = cfg.dataiter.inp_res // 32
    return CDPN(depth=cfg.network.back_layers_num, feat_hw=(feat, feat),
                backbone_dtype=torch.bfloat16 if cfg.network.bf16_backbone
                else None)


def build_all(cfg: SixDoFConfig, cam_intrinsic=None, device=None,
              data_parallel: bool = False):
    """Model (on ``device``), PnP stack and train step (averaging over the
    replicas with ``data_parallel``).

    Returns ``(model, epropnp, step_fn)``; the optimizer needs the model's
    parameters and comes with the state (:func:`init_state`).
    """
    device = _device(device)
    model = build_cdpn(cfg).to(device)
    epropnp = train_lib.build_epropnp(cfg)
    cam = torch.tensor(np.asarray(ref.CAMERA_MATRIX if cam_intrinsic is None
                                  else cam_intrinsic), dtype=torch.float32,
                       device=device)
    step_fn = train_lib.make_train_step(epropnp, cfg, cam,
                                        data_parallel=data_parallel)
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
               resume_from: Optional[str] = None,
               data_parallel: bool = False, log_interval: int = 20,
               seed: int = 0, prefetch: int = 2, ckpt_interval: int = 1,
               device=None, on_step: Optional[Callable] = None):
    """Epoch loop over ``dataset``, any object with ``__len__`` and
    ``batches(batch_size, shuffle, seed)`` yielding ``Batch`` records of
    numpy arrays or tensors.

    ``data_parallel``: one replica per process of a ``torch.distributed``
    group (``parallel.mesh.init_data_parallel``: the ``torchrun``
    environment, or a group of one), as JAX's ``make_sharded_step``.
    ``cfg.train.train_batch_size`` is the global batch; each rank trains on
    its rows (``mesh.rank_rows``), which ``dataset.batches(...,
    rows=rows)`` must yield: the rows of the global batch the loop would
    build alone, bit for bit. Every rank seeds its generator alike, as JAX
    replicates its key; rank 0 alone logs and writes the checkpoints.

    ``prefetch`` > 0 runs the batch generator on a background thread
    (``parallel.prefetch.BackgroundIterator``, ``prefetch + 1`` batches
    ahead) and keeps ``prefetch`` batches on the device ahead of the step
    (``prefetch_to_device``: pinned, non-blocking copies on a side
    stream); 0 iterates synchronously. Either way the batches and the
    steps are the same.

    ``on_step(epoch, i, metrics)``, when given, is called after every step
    with the step's metrics (tensors on the device). Returns the state.
    """
    device = _device(device)
    rows = None
    if data_parallel:
        device = mesh.init_data_parallel(device).device
        rows = mesh.rank_rows(cfg.train.train_batch_size)
    logger = mesh.replica_logger('epropnp_tpu_torch.6dof', save_dir)
    n_batches = max(len(dataset) // cfg.train.train_batch_size, 1)
    model, _, step_fn = build_all(cfg, device=device,
                                  data_parallel=data_parallel)
    state = init_state(cfg, model, n_batches, seed)
    if cfg.load_model:
        load_checkpoint(cfg.load_model, state,
                        filter_fn=lambda k: k == 'params')
        logger.info('loaded params from %s', cfg.load_model)
    if resume_from:
        load_checkpoint(resume_from, state)
        logger.info('resumed full state from %s', resume_from)
    mesh.broadcast_state(state)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)

    for epoch in range(cfg.train.begin_epoch, cfg.train.end_epoch):
        meters = {}
        t0 = time.time()
        batches = dataset.batches(
            cfg.train.train_batch_size, shuffle=True, seed=seed + epoch,
            **({} if rows is None else dict(rows=rows)))
        if prefetch > 0:
            batches = prefetch_to_device(
                BackgroundIterator(batches, maxsize=prefetch + 1),
                depth=prefetch, device=device)
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
            if mesh.is_main():
                save_checkpoint(ckpt, state)
                save_checkpoint(os.path.join(save_dir, 'latest.pt'), state)
            mesh.barrier()
            logger.info('epoch %d done, checkpoint -> %s', epoch, ckpt)
        else:
            logger.info('epoch %d done', epoch)
    return state


def load_cdpn(cfg: SixDoFConfig, checkpoint: str, device=None) -> CDPN:
    """A CDPN in eval mode on ``device`` holding a checkpoint's parameters
    and BatchNorm statistics: a JAX checkpoint (flax msgpack, a variables
    or train-state file; ``utils.checkpoint.load_jax_variables``) or one
    of the port's (``.pt``, ``save_checkpoint`` of a ``TrainState``).
    The model is :func:`build_cdpn`'s: with ``network.bf16_backbone`` it
    evaluates with a bf16 backbone, as JAX's ``test_loop``."""
    device = _device(device)
    model = build_cdpn(cfg)
    if checkpoint.endswith(TORCH_SUFFIXES):
        state = train_lib.TrainState(model, train_lib.make_optimizer(
            cfg, model, 1))
        load_checkpoint(checkpoint, state,
                        filter_fn=lambda k: k in ('params', 'batch_stats'))
    else:
        feat = cfg.dataiter.inp_res // 32
        model.load_state_dict(cdpn_state_dict(
            load_jax_variables(checkpoint), cfg.network.back_layers_num,
            feat_hw=(feat, feat)), strict=True)
    return model.to(device).eval()


def test_loop(cfg: SixDoFConfig, dataset, state, models, diameters,
              init: str = 'epnp', batch_size: int = 32,
              log_interval: int = 20, cache_file: Optional[str] = None,
              orient_density_dir: Optional[str] = None, device=None,
              rng: Optional[torch.Generator] = None):
    """Evaluate a trained model on a test split (the reference's
    lib/test.py), the counterpart of the JAX ``test_loop``.

    Args:
        dataset: ``len``, ``dataset[i]`` -> ``dataset.Sample``, ``classes``
            and ``min_extents(cls)`` (``dataset.LineMODDataset``).
        state: a checkpoint path (:func:`load_cdpn`) or a ``CDPN``.
        models: {class name: (n, 3) model points}; diameters likewise.
        init: the pose init of ``test.infer_poses``.
        cache_file: an ``.npz`` path: if it exists, its predictions are
            evaluated and inference is skipped; otherwise the predictions
            are saved there after the loop (the reference's
            lib/test.py:44-74).
        orient_density_dir: if set, the SO(3) orientation density of every
            sample is rendered there (lib/test.py:218-225; needs cv2).
        rng: ``torch.Generator`` of the RSLM init and the density's draws.

    Returns the metric dicts of ``eval_metrics.PoseEvaluator``: ``pose``,
    ``add`` and ``arp_2d``.
    """
    from . import test as test_lib
    from .dataset import collate
    from .eval_metrics import PoseEvaluator

    logger = get_logger('epropnp_tpu_torch.6dof')
    evaluator = PoseEvaluator(list(models), models, diameters,
                              cam_k=np.asarray(ref.CAMERA_MATRIX))

    def metrics():
        return dict(pose=evaluator.evaluate_pose(),
                    add=evaluator.evaluate_pose_add(),
                    arp_2d=evaluator.evaluate_pose_arp_2d())

    if cache_file and os.path.exists(cache_file):
        data = np.load(cache_file)
        logger.info('loaded %d cached predictions from %s',
                    len(data['obj']), cache_file)
        for k in range(len(data['obj'])):
            evaluator.update(str(data['obj'][k]), data['pose_est'][k],
                             data['pose_gt'][k])
        return metrics()
    device = _device(device)
    model = (load_cdpn(cfg, state, device) if isinstance(state, str)
             else state.to(device).eval())
    cam = torch.tensor(ref.CAMERA_MATRIX, dtype=torch.float32, device=device)
    refine_fn = test_lib.make_refine_fn(cfg, cam)
    extents = {c: dataset.min_extents(c) for c in dataset.classes}
    n = len(dataset)
    cache = {'obj': [], 'pose_est': [], 'pose_gt': []}
    if orient_density_dir:
        os.makedirs(orient_density_dir, exist_ok=True)
    for start in range(0, n, batch_size):
        samples = [dataset[i] for i in range(start, min(start + batch_size,
                                                        n))]
        batch = collate(samples, extents, device)
        with torch.no_grad():
            outs = model(batch.inp)
        box_wh = torch.tensor(np.stack([s.box[2:] for s in samples]),
                              dtype=torch.float32, device=device)
        res = test_lib.infer_poses(outs, batch, box_wh, cam, cfg,
                                   refine_fn=refine_fn, init=init, rng=rng)
        pose_est = res.pose_est.cpu().numpy()
        for k, s in enumerate(samples):
            evaluator.update(s.obj, pose_est[k], np.asarray(s.pose))
            cache['obj'].append(s.obj)
            cache['pose_est'].append(pose_est[k])
            cache['pose_gt'].append(np.asarray(s.pose))
        if orient_density_dir:
            import cv2
            imgs = test_lib.orient_density_images(outs, batch, cam, cfg,
                                                  rng=rng)
            for k, img in enumerate(imgs):
                cv2.imwrite(os.path.join(
                    orient_density_dir,
                    f'{samples[k].obj}_{start + k:06d}.png'), img)
        if (start // batch_size) % log_interval == 0:
            logger.info('eval %d/%d', start + len(samples), n)
    if cache_file:
        np.savez_compressed(
            cache_file, obj=np.asarray(cache['obj']),
            pose_est=np.stack(cache['pose_est']),
            pose_gt=np.stack(cache['pose_gt']))
        logger.info('cached %d predictions -> %s', n, cache_file)
    return metrics()
