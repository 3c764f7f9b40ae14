"""CLI: train the 6DoF suite on a LineMOD-format tree (PyTorch), the
counterpart of ``tools/train_6dof.py``.

  python -m epropnp_tpu_torch.tools.train_6dof --exp epropnp_basic \
      --data /path/to/lm --save runs/epropnp_basic

``--exp`` picks one of the released experiment configs. The frames are
read and cropped on the host by ``sixdof.dataset.LineMODDataset`` (no
OpenCV: ``utils.image_ops``), on a background thread ahead of the step,
and training runs on the CUDA card unless ``--device`` says otherwise,
with the PnP solves through the fused kernels (K1; their torch twins on
the CPU). Each epoch writes ``checkpoint_{epoch:03d}.pt`` and
``latest.pt`` into ``--save``, which ``tools.test_6dof`` loads.

Data-parallel, one process per replica:

  torchrun --nproc-per-node N -m epropnp_tpu_torch.tools.train_6dof \
      --data-parallel --exp epropnp_basic --data /path/to/lm

``--batch-size`` (32 in the configs) is then the global batch; each rank
reads and trains on its ``1/N`` of every batch's frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..sixdof.config import PnPConfig, SixDoFConfig
from ..utils import cuda_setup

EXPS = ('epropnp_basic', 'epropnp_reg_loss', 'epropnp_cdpn_init',
        'epropnp_cdpn_init_long')
# ``--smoke``: a tiny backbone and solver, so the whole CLI path runs in
# minutes on the CPU (not a training recipe); the JAX CLIs' values
SMOKE_PNP = dict(mc_samples=16, num_iter=2, lm_num_iter=3, rs_num_points=8,
                 rs_num_proposals=4, rs_num_iter=1)


def with_fused_solves(cfg: SixDoFConfig) -> SixDoFConfig:
    """``cfg`` with its PnP solves through the fused kernels: K1 on CUDA
    tensors, its torch twin on CPU tensors (``PnPConfig.use_pallas``)."""
    return dataclasses.replace(
        cfg, pnp=dataclasses.replace(cfg.pnp, use_pallas=True))


def smoke_config(cfg: SixDoFConfig, sample_points: bool) -> SixDoFConfig:
    """The ``--smoke`` reduction of the JAX CLIs: ResNet-18 and a small
    solver (and 64 training points, with ``sample_points``)."""
    cfg = dataclasses.replace(
        cfg, network=dataclasses.replace(cfg.network, back_layers_num=18),
        pnp=PnPConfig(**SMOKE_PNP))
    if sample_points:
        cfg = dataclasses.replace(cfg, dataiter=dataclasses.replace(
            cfg.dataiter, sample_points=64))
    return cfg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--exp', default='epropnp_basic', choices=EXPS)
    p.add_argument('--data', required=True, help='LineMOD root directory')
    p.add_argument('--save', default='runs/sixdof')
    p.add_argument('--load-model', default=None,
                   help='checkpoint for CDPN-init experiments')
    p.add_argument('--resume-from', default=None)
    p.add_argument('--data-parallel', action='store_true',
                   help='one replica per process of a torch.distributed '
                        'group (torchrun; without it a group of one); '
                        '--batch-size is the global batch')
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--bg-dir', default=None,
                   help='background-substitution images: a PASCAL VOC '
                        'root (VOC2012/... layout, reference behavior) '
                        'or a flat image directory')
    p.add_argument('--change-bg-ratio', type=float, default=0.5)
    p.add_argument('--smoke', action='store_true',
                   help='CI smoke mode: tiny backbone/solver so the '
                        'full CLI path runs in minutes on CPU '
                        '(NOT a training recipe)')
    p.add_argument('--device', default='cuda')
    return p


def main(argv=None):
    cuda_setup.configure_cuda()
    p = build_parser()
    args = p.parse_args(argv)
    if args.exp in ('epropnp_cdpn_init', 'epropnp_cdpn_init_long'):
        if not args.load_model:
            p.error(f'--load-model is required for {args.exp}')
        cfg = getattr(SixDoFConfig, args.exp)(args.load_model)
    else:
        cfg = getattr(SixDoFConfig, args.exp)()
    train = cfg.train
    if args.batch_size:
        train = dataclasses.replace(train, train_batch_size=args.batch_size)
    if args.epochs:
        train = dataclasses.replace(train, end_epoch=args.epochs)
    cfg = dataclasses.replace(cfg, train=train)
    world = int(os.environ.get('WORLD_SIZE', 1))
    if args.data_parallel and train.train_batch_size % world:
        p.error(f'the global batch {train.train_batch_size} must divide by '
                f'the {world} ranks of --data-parallel')
    if args.smoke:
        cfg = smoke_config(cfg, sample_points=True)
    cfg = with_fused_solves(cfg)

    from ..sixdof.dataset import LineMODDataset
    from ..sixdof.main import train_loop
    dataset = LineMODDataset(cfg, args.data, split='train',
                             bg_dir=args.bg_dir,
                             change_bg_ratio=args.change_bg_ratio)
    if len(dataset) == 0:
        p.error(f'no samples found under {args.data}')
    return train_loop(cfg, dataset, args.save, resume_from=args.resume_from,
                      data_parallel=args.data_parallel, device=args.device)


if __name__ == '__main__':
    main()
