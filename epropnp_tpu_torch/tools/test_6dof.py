"""CLI: evaluate the 6DoF suite on a LineMOD-format tree (ADD, n-deg n-cm
and ARP metrics; PyTorch), the counterpart of ``tools/test_6dof.py``.

  python -m epropnp_tpu_torch.tools.test_6dof --exp epropnp_basic \
      --data /data/lm --checkpoint runs/6dof/latest.pt

``--checkpoint`` is the port's ``.pt`` (``tools.train_6dof``) or a JAX
msgpack file (``utils.checkpoint``). The tree holds
``models/models_info.txt`` and ``models/obj_XX.ply`` beside the frames.
``--init epnp`` solves the EPnP init on the host with ``cv2.solvePnP``;
``epnp_device`` solves it on the device (no OpenCV); ``rslm`` draws RSLM
proposals. Inference runs on the CUDA card unless ``--device`` says
otherwise; the refinement goes through the fused kernel (K1). Prints the
mean metrics as JSON.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..sixdof import ref_constants as ref
from ..sixdof.config import SixDoFConfig
from ..utils import cuda_setup
from .train_6dof import smoke_config, with_fused_solves

INITS = ('epnp', 'epnp_device', 'rslm')


def load_models(data: str):
    """``models/models_info.txt`` and the classes' ``obj_XX.ply`` under
    ``data``: (model_info {class: info in mm}, models {class: (n, 3)
    points in m}, diameters {class: m}); None if the info file is
    missing."""
    from ..sixdof.model_points import load_models_info, load_ply_vertices
    info_path = os.path.join(data, 'models', 'models_info.txt')
    if not os.path.isfile(info_path):
        return None
    infos = load_models_info(info_path)
    model_info = {ref.IDX2OBJ[i]: v for i, v in infos.items()
                  if i in ref.IDX2OBJ}
    models, diameters = {}, {}
    for cls in ref.LM_OBJECTS:
        ply = os.path.join(data, 'models', f'obj_{ref.OBJ2IDX[cls]:02d}.ply')
        if os.path.isfile(ply) and cls in model_info:
            models[cls] = load_ply_vertices(ply) / 1000.0
            diameters[cls] = model_info[cls]['diameter'] / 1000.0
    return model_info, models, diameters


def mean_metrics(metrics) -> dict:
    """The ``mean`` entry of each metric dict, as the JAX CLI prints it."""
    return {k: {c: v for c, v in m.items() if c == 'mean'}
            for k, m in metrics.items() if isinstance(m, dict)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--exp', default='epropnp_basic')
    p.add_argument('--data', required=True)
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--init', default='epnp', choices=INITS)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--smoke', action='store_true',
                   help='CI smoke mode: tiny backbone/refiner matching '
                        'train_6dof --smoke checkpoints')
    p.add_argument('--device', default='cuda')
    return p


def main(argv=None):
    cuda_setup.configure_cuda()
    p = build_parser()
    args = p.parse_args(argv)
    from ..sixdof import main as main_lib
    from ..sixdof.dataset import LineMODDataset

    cfg = SixDoFConfig(exp_id=args.exp)
    if args.smoke:
        cfg = smoke_config(cfg, sample_points=False)
    cfg = with_fused_solves(cfg)
    loaded = load_models(args.data)
    if loaded is None:
        p.error(f'missing {os.path.join(args.data, "models", "models_info.txt")}')
    model_info, models, diameters = loaded
    dataset = LineMODDataset(cfg, args.data, split='test',
                             classes=list(models), model_info=model_info)
    if len(dataset) == 0:
        p.error(f'no test samples under {args.data}')
    device = torch.device(args.device)
    metrics = main_lib.test_loop(
        cfg, dataset, args.checkpoint, models, diameters, init=args.init,
        batch_size=args.batch_size, device=device,
        rng=torch.Generator(device).manual_seed(0))
    print(json.dumps(
        mean_metrics(metrics),
        default=lambda o: o.tolist() if hasattr(o, 'tolist') else str(o),
        indent=2))
    return metrics


if __name__ == '__main__':
    main()
