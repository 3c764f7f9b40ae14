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

``--data-parallel`` splits every batch over the ranks of a
``torch.distributed`` group (``torchrun --nproc-per-node N -m
epropnp_tpu_torch.tools.test_det --data-parallel ...``), the counterpart
of JAX's ``data_parallel_infer``; rank 0 gathers the detections, fuses
and scores them.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..det.config import DetConfig
from ..det.pipelines import imread as read_frame
from ..parallel import mesh
from ..utils import cuda_setup
from ..utils.timer import IterTimers

CONFIGS = ('basic', 'coord_regr', 'v1b', 'smoke')


def shard_rows(n: int, shard: Optional[Tuple[int, int]]) -> slice:
    """The rows of a batch of ``n`` frames that ``shard`` = (rank, world)
    serves: its block (``mesh.rank_rows``); a batch that does not divide,
    the last, goes whole to rank 0, as JAX's tail runs on one device."""
    if shard is None:
        return slice(None)
    rank, world = shard
    if n % world:
        return slice(None) if rank == 0 else slice(0)
    return mesh.rank_rows(n, rank, world)


def infer_dataset(model, cfg: DetConfig, dataset, data_root: str,
                  batch_size: int = 6, tta: bool = False,
                  imread: Callable[[str], np.ndarray] = read_frame,
                  rng: Optional[torch.Generator] = None,
                  timers: Optional[IterTimers] = None,
                  on_batch: Optional[Callable[[int], None]] = None,
                  shard: Optional[Tuple[int, int]] = None) -> List:
    """Serve ``dataset``'s frames in batches of ``batch_size`` (the
    inference function made once; ``tta`` the flip TTA): a list of
    ``(frame index, {'bbox_3d_results': ...})`` in frame order. With
    ``shard`` = (rank, world), only that rank's rows of each batch
    (:func:`shard_rows`). ``rng`` draws the RSLM samples (a generator on
    the card keeps them there). ``timers`` times 'read time' (the frames
    from disk) and the stages of ``det.api.inference_detector``;
    ``on_batch(i)`` is called after batch ``i``."""
    from ..det import test as dtest
    from ..det.api import inference_detector
    timers = timers or IterTimers(enabled=False)
    infer_fn = (dtest.make_tta_inference_fn if tta
                else dtest.make_inference_fn)(model, cfg)
    results = []
    for b, i in enumerate(range(0, len(dataset), batch_size)):
        frames = list(range(i, min(i + batch_size, len(dataset))))
        frames = frames[shard_rows(len(frames), shard)]
        if frames:
            infos = [dataset.data_infos[f] for f in frames]
            with timers('read time'):
                imgs = [imread(os.path.join(data_root, info['img_path']))
                        for info in infos]
            cams = [np.asarray(info['cam_intrinsic']) for info in infos]
            _, out3d = inference_detector(model, cfg, imgs, cams,
                                          infer_fn=infer_fn, rng=rng,
                                          timers=timers, tta=tta)
            results.extend((f, dict(bbox_3d_results=per_img))
                           for f, per_img in zip(frames, out3d))
        if on_batch is not None:
            on_batch(b)
    return results


def evaluate_dataset(model, cfg: DetConfig, dataset, data_root: str,
                     out_dir: str, batch_size: int = 6, tta: bool = False,
                     imread: Callable[[str], np.ndarray] = read_frame,
                     rng: Optional[torch.Generator] = None,
                     timers: Optional[IterTimers] = None,
                     on_batch: Optional[Callable[[int], None]] = None,
                     data_parallel: bool = False) -> Optional[Dict]:
    """Serve ``dataset``'s frames (:func:`infer_dataset`) and score them
    with ``dataset.evaluate`` into ``out_dir`` (``results_nusc.json``).
    Returns the metrics dict. ``timers`` also times 'fusion + eval time'.

    ``data_parallel``: every rank of the ``torch.distributed`` group
    serves its rows of each batch (a rank's generator seeded as every
    other's, as JAX replicates its key), and rank 0 gathers the results in
    frame order, fuses and scores them; it returns the metrics, the other
    ranks None after it. The detections are those of one single-process
    run per shard with the same seed (JAX's rule for
    ``data_parallel_infer``)."""
    timers = timers or IterTimers(enabled=False)
    shard = (mesh.rank(), mesh.world_size()) if data_parallel else None
    results = infer_dataset(model, cfg, dataset, data_root, batch_size,
                            tta, imread, rng, timers, on_batch, shard)
    if data_parallel:
        gathered = mesh.gather_to_main(results)
        if not mesh.is_main():
            mesh.barrier()
            return None
        results = sorted((r for part in gathered for r in part),
                         key=lambda r: r[0])
    with timers('fusion + eval time'):
        metrics = dataset.evaluate([r for _, r in results], out_dir)
    if data_parallel:
        mesh.barrier()
    return metrics


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
                   help='split every batch over the ranks of a '
                        'torch.distributed group (torchrun; without it a '
                        'group of one); rank 0 fuses and scores')
    p.add_argument('--timer', action='store_true')
    p.add_argument('--device', default='cuda')
    return p


def main(argv=None):
    cuda_setup.configure_cuda()
    p = build_parser()
    args = p.parse_args(argv)
    if args.data_parallel:
        world = int(os.environ.get('WORLD_SIZE', 1))
        if args.batch_size % world:
            p.error(f'--batch-size {args.batch_size} must divide by the '
                    f'{world} ranks of --data-parallel')
    from ..det.api import init_detector
    from ..det.nuscenes_dataset import NuScenes3DDataset
    if not os.path.isfile(args.ann):
        p.error(f'annotation file not found: {args.ann}')
    cfg = getattr(DetConfig, args.config)()
    device, rng = args.device, None
    if args.data_parallel:
        device = mesh.init_data_parallel(args.device).device
        rng = torch.Generator(device).manual_seed(0)
    dataset = NuScenes3DDataset(args.ann, img_prefix=args.data)
    model = init_detector(cfg, args.checkpoint, device=device)
    timers = IterTimers(enabled=args.timer)
    n = len(dataset)
    metrics = evaluate_dataset(
        model, cfg, dataset, args.data, args.out,
        batch_size=args.batch_size, tta=args.tta, rng=rng, timers=timers,
        on_batch=lambda b: mesh.is_main() and print(
            f'\r{min((b + 1) * args.batch_size, n)}/{n}', end=''),
        data_parallel=args.data_parallel)
    if not mesh.is_main():
        return None
    print()
    if args.timer:
        print(timers.summary())
    print(json.dumps(metrics, default=str))
    return metrics


if __name__ == '__main__':
    main()
