"""CLI: train the Det suite on a nuScenes-format tree (PyTorch), the
counterpart of ``tools/train_det.py``.

  python -m epropnp_tpu_torch.tools.train_det --config v1b \
      --ann train_infos.pkl --data /path/to/nuscenes --save runs/det

The annotation files are the converter's info pickles
(``tools/nuscenes_converter.py``). Frames are read by
``det.pipelines.imread``: ``.npy`` arrays by numpy, other images by cv2.
Training runs on the CUDA card unless ``--device`` says otherwise; each
epoch writes ``checkpoint_{epoch:03d}.pt`` and ``latest.pt`` into
``--save``, which ``det.api.init_detector`` and ``tools.test_det`` load.

Data-parallel, one process per replica:

  torchrun --nproc-per-node N -m epropnp_tpu_torch.tools.train_det \
      --data-parallel --config v1b --batch-size 12 ...

``--batch-size`` is then the global batch (each rank trains on its
``1/N`` of the rows); NCCL when every rank has its own card, gloo when
ranks share one (``parallel.mesh.init_data_parallel``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable

import numpy as np

from ..det.config import DetConfig
from ..det.pipelines import (REFERENCE_CROP_BOX, collate_det_batch,
                             default_pipeline, imread as read_frame)
from ..utils import cuda_setup

CONFIGS = ('basic', 'coord_regr', 'coord_regr_trainval', 'no_reproj', 'v1b',
           'v1b_220312', 'smoke')


def steps_per_epoch(dataset, cfg: DetConfig) -> int:
    """Full batches of ``cfg.train.batch_size`` in one pass (at least 1)."""
    return max(len(dataset) // cfg.train.batch_size, 1)


def frame_shape(path: str, imread: Callable[[str], np.ndarray] = read_frame):
    """``(h, w)`` of a frame: a ``.npy`` array's from its header, another
    image's by ``imread``."""
    if path.endswith('.npy'):
        return np.load(path, mmap_mode='r').shape[:2]
    return imread(path).shape[:2]


def make_batch_iter(dataset, cfg: DetConfig, data_root: str,
                    imread: Callable[[str], np.ndarray] = read_frame,
                    crop: bool = True):
    """``batch_iter(epoch)``: the epoch's ``det.train.DetBatch`` records
    (tensors on the CPU; ``det.main.train_loop`` moves them to its
    device), ``steps_per_epoch`` of them, as the JAX CLI composes them.

    Each sample is the dataset's info read from ``data_root`` by
    ``imread``, its parsed annotations (with the object points of an OC
    cache, if the converter wrote one) and ``default_pipeline`` in
    training mode (flip, then the reference crop unless ``crop`` is
    False). The draws are JAX's, from ``np.random.default_rng(epoch)``:
    the permutation, then per sample the pipeline's; a sample the crop
    leaves without objects is dropped, and once the permutation is spent
    an index is drawn to fill the batch. So one seed gives JAX's batches.

    ``batch_iter(epoch, rows)`` yields a data-parallel rank's rows of
    those batches (``parallel.mesh.rank_rows``): the draws and drops of
    the whole batch are made in that order, on the annotations and the
    frame's shape alone (a ``.npy`` frame's header), and only the rank's
    frames are read and run through the pipeline.
    """
    bs = cfg.train.batch_size
    steps = steps_per_epoch(dataset, cfg)
    max_gt = cfg.train.max_gt_per_img
    max_pts = 128 if cfg.with_loss_regr else 0

    def load_sample(j, rng, read=True):
        info = dataset.data_infos[j]
        gt = dataset.parse_ann_info(info)
        path = os.path.join(data_root, info['img_path'])
        s = dict(cam_intrinsic=np.asarray(info['cam_intrinsic']),
                 gt_bboxes=gt['bboxes'], gt_labels=gt['labels'],
                 gt_bboxes_3d=gt['bboxes_3d'], gt_velo=gt['velos'],
                 gt_attr=gt['attrs'], gt_bboxes_ignore=gt['bboxes_ignore'],
                 truncation=gt['truncation'])
        if 'x3d' in gt:
            s.update(gt_x3d=gt['x3d'], gt_x2d=gt['x2d'])
        if read:
            s['img'] = imread(path)
        else:  # another rank's frame: its draws, not its pixels
            s['img_shape'] = frame_shape(path, imread)
        return default_pipeline(
            s, rng, training=True,
            crop_box=REFERENCE_CROP_BOX if crop else None)

    def batch_iter(epoch, rows: slice = slice(None)):
        mine = set(range(bs)[rows])
        rng = np.random.default_rng(epoch)
        order = iter(rng.permutation(len(dataset)))
        for _ in range(steps):
            samples, attempts = [], 0
            while len(samples) < bs:
                attempts += 1
                if attempts > 100 * bs:
                    raise RuntimeError(
                        'every drawn sample was dropped by the pipeline '
                        '(no valid GT after the crop): check annotations')
                j = next(order, None)
                if j is None:  # backfill dropped samples: fixed batch
                    j = int(rng.integers(len(dataset)))
                s = load_sample(j, rng, read=len(samples) in mine)
                if s is not None:
                    samples.append(s)
            yield collate_det_batch(samples[rows], max_gt, max_pts=max_pts,
                                    device='cpu')
    return batch_iter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', default='basic', choices=CONFIGS)
    p.add_argument('--ann', required=True, nargs='+',
                   help='converter pickle(s); pass train+val for trainval')
    p.add_argument('--data', default='', help='nuScenes dataroot')
    p.add_argument('--save', default='runs/det')
    p.add_argument('--resume-from', default=None)
    p.add_argument('--load-torch', default=None,
                   help='torch checkpoint to graft before training: a '
                        'torchvision ImageNet ResNet, an mmdet backbone+neck '
                        'file, or a full released EPro-PnP-Det checkpoint')
    p.add_argument('--data-parallel', action='store_true',
                   help='one replica per process of a torch.distributed '
                        'group (torchrun; without it a group of one); '
                        '--batch-size is the global batch')
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--img-hw', type=int, nargs=2, default=(672, 1600),
                   help="the JAX CLI's model-build geometry; the port "
                        'builds without it and accepts it for the same '
                        'command lines')
    p.add_argument('--no-crop', action='store_true',
                   help='disable the reference Crop3D sky-band crop')
    p.add_argument('--device', default='cuda')
    return p


def main(argv=None):
    cuda_setup.configure_cuda()
    p = build_parser()
    args = p.parse_args(argv)
    from ..det.api import torch_checkpoint_has_dcn_offsets
    from ..det.main import train_loop
    from ..det.nuscenes_dataset import NuScenes3DDataset

    cfg = getattr(DetConfig, args.config)()
    if args.load_torch and torch_checkpoint_has_dcn_offsets(args.load_torch):
        # mmcv-trained DCNv2 weights want mmcv's plain-sigmoid modulation
        cfg = dataclasses.replace(cfg, dcn_modulation_scale=1.0)
    if args.batch_size:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           batch_size=args.batch_size))
    world = int(os.environ.get('WORLD_SIZE', 1))
    if args.data_parallel and cfg.train.batch_size % world:
        p.error(f'the global batch {cfg.train.batch_size} must divide by '
                f'the {world} ranks of --data-parallel')
    dataset = NuScenes3DDataset(args.ann, img_prefix=args.data)
    if len(dataset) == 0:
        p.error(f'no samples in {args.ann}')
    return train_loop(
        cfg, make_batch_iter(dataset, cfg, args.data, crop=not args.no_crop),
        steps_per_epoch(dataset, cfg), args.save,
        resume_from=args.resume_from, load_torch=args.load_torch,
        data_parallel=args.data_parallel, device=args.device)


if __name__ == '__main__':
    main()
