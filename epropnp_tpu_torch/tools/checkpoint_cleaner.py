"""Strip the optimizer state from a training checkpoint of the port (the
deploy size), the counterpart of the JAX package's
``tools/checkpoint_cleaner.py`` (the reference's
tools/checkpoint_cleaner.py:10-16).

A checkpoint of ``utils.checkpoint.save_checkpoint`` holds ``{'state',
'optimizer'}``; the result holds ``state`` alone (parameters, BatchNorm
statistics, the loss normalisers, the step) and still loads for serving
and evaluation: ``det.api.init_detector`` / ``load_train_state_model``
(Det) and ``sixdof.main.load_cdpn`` (6DoF). It no longer resumes
training.

  python -m epropnp_tpu_torch.tools.checkpoint_cleaner in.pt out.pt
"""

from __future__ import annotations

import argparse
import os

import torch


def clean(src: str, dst: str) -> list:
    """Write ``src`` without its ``optimizer`` entry to ``dst`` (atomically,
    as ``save_checkpoint``); returns the kept top-level keys."""
    data = torch.load(src, map_location='cpu', weights_only=True)
    kept = {k: v for k, v in data.items() if k != 'optimizer'}
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    tmp = dst + '.tmp'
    torch.save(kept, tmp)
    os.replace(tmp, dst)
    return sorted(kept)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('src')
    p.add_argument('dst')
    args = p.parse_args(argv)
    kept = clean(args.src, args.dst)
    print(f'{args.src} ({os.path.getsize(args.src)} B) -> {args.dst} '
          f'({os.path.getsize(args.dst)} B), kept: {kept}')


if __name__ == '__main__':
    main()
