"""CLI: evaluate the Det suite on a nuScenes-format tree (PyTorch): the
detector serves every camera frame, the frames of a sample are fused in
the global frame, the submission is written and scored (NDS/mAP). The
counterpart of ``tools/test_det.py``.

  python -m epropnp_tpu_torch.tools.test_det --config v1b \
      --checkpoint runs/det/latest.pt --ann val_infos.pkl \
      --data /path/to/nuscenes --out runs/det_eval

The checkpoint is the port's own ``latest.pt`` (``tools.train_det``), a
JAX msgpack file or an external torch file (``det.api.init_detector``).
Without the nuScenes devkit the metrics are the self-contained
``detection_cvpr_2019`` protocol of ``det.nuscenes_eval``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..det.config import DetConfig
from ..det.pipelines import imread as read_frame
from ..utils import cuda_setup
from ..utils.timer import IterTimers

CONFIGS = ('basic', 'coord_regr', 'v1b', 'smoke')


def evaluate_dataset(model, cfg: DetConfig, dataset, data_root: str,
                     out_dir: str, batch_size: int = 6, tta: bool = False,
                     imread: Callable[[str], np.ndarray] = read_frame,
                     rng: Optional[torch.Generator] = None,
                     timers: Optional[IterTimers] = None,
                     on_batch: Optional[Callable[[int], None]] = None
                     ) -> Dict:
    """Serve ``dataset``'s frames in batches of ``batch_size`` (the
    inference function made once; ``tta`` the flip TTA) and score them
    with ``dataset.evaluate`` into ``out_dir`` (``results_nusc.json``).
    Returns the metrics dict. ``rng`` draws the RSLM samples (a
    generator on the card keeps them there). ``timers`` times 'read
    time' (the frames from disk), the stages of
    ``det.api.inference_detector`` and 'fusion + eval time';
    ``on_batch(i)`` is called after batch ``i``."""
    from ..det import test as dtest
    from ..det.api import inference_detector
    timers = timers or IterTimers(enabled=False)
    infer_fn = (dtest.make_tta_inference_fn if tta
                else dtest.make_inference_fn)(model, cfg)
    results = []
    for b, i in enumerate(range(0, len(dataset), batch_size)):
        infos = dataset.data_infos[i:i + batch_size]
        with timers('read time'):
            imgs = [imread(os.path.join(data_root, info['img_path']))
                    for info in infos]
        cams = [np.asarray(info['cam_intrinsic']) for info in infos]
        _, out3d = inference_detector(model, cfg, imgs, cams,
                                      infer_fn=infer_fn, rng=rng,
                                      timers=timers, tta=tta)
        results.extend(dict(bbox_3d_results=per_img) for per_img in out3d)
        if on_batch is not None:
            on_batch(b)
    with timers('fusion + eval time'):
        return dataset.evaluate(results, out_dir)


def unfiltered(dataset):
    """A shallow copy of a ``NuScenes3DDataset`` whose ``parse_ann_info``
    keeps every annotation of the ten classes (no visibility, truncation
    or size filter)."""
    full = copy.copy(dataset)
    full.trunc_ignore_thres, full.min_box_size, full.min_visibility = \
        1.0, 0.0, 0
    return full


def ground_truth_results(dataset) -> List[Dict]:
    """Every annotation of every frame as a detection of score 1 (the
    ``bbox_3d_results`` layout: per class, rows [l, h, w, x, y, z, ry,
    score, vx, vz]), none filtered out: fed to ``dataset.evaluate``, a
    check of the fusion and the metrics, which must score it near 1."""
    from ..det.nuscenes_dataset import CLASSES
    full = unfiltered(dataset)
    out = []
    for info in dataset.data_infos:
        gt = full.parse_ann_info(info)
        rows = np.concatenate([gt['bboxes_3d'],
                               np.ones((len(gt['labels']), 1)),
                               np.nan_to_num(gt['velos'])], 1)
        out.append(dict(bbox_3d_results=[
            rows[gt['labels'] == c] for c in range(len(CLASSES))]))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', default='basic', choices=CONFIGS)
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--ann', required=True, help='converter pickle')
    p.add_argument('--data', default='', help='nuScenes dataroot')
    p.add_argument('--out', default='runs/det_eval')
    p.add_argument('--batch-size', type=int, default=6)
    p.add_argument('--img-hw', type=int, nargs=2, default=(672, 1600),
                   help="the JAX CLI's model-build geometry; the port "
                        'builds without it and accepts it for the same '
                        'command lines')
    p.add_argument('--tta', action='store_true',
                   help='horizontal-flip test-time augmentation')
    p.add_argument('--data-parallel', action='store_true',
                   help='not ported (ROADMAP A.5); refused')
    p.add_argument('--timer', action='store_true')
    p.add_argument('--device', default='cuda')
    return p


def main(argv=None):
    cuda_setup.configure_cuda()
    p = build_parser()
    args = p.parse_args(argv)
    if args.data_parallel:
        p.error('--data-parallel is not ported yet (ROADMAP A.5: '
                'data-parallel serving); evaluate on one device')
    from ..det.api import init_detector
    from ..det.nuscenes_dataset import NuScenes3DDataset
    if not os.path.isfile(args.ann):
        p.error(f'annotation file not found: {args.ann}')
    cfg = getattr(DetConfig, args.config)()
    dataset = NuScenes3DDataset(args.ann, img_prefix=args.data)
    model = init_detector(cfg, args.checkpoint, device=args.device)
    timers = IterTimers(enabled=args.timer)
    n = len(dataset)
    metrics = evaluate_dataset(
        model, cfg, dataset, args.data, args.out,
        batch_size=args.batch_size, tta=args.tta, timers=timers,
        on_batch=lambda b: print(
            f'\r{min((b + 1) * args.batch_size, n)}/{n}', end=''))
    print()
    if args.timer:
        print(timers.summary())
    print(json.dumps(metrics, default=str))


if __name__ == '__main__':
    main()
