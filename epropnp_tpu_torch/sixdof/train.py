"""6DoF batch layout and correspondence construction (PyTorch).

Counterpart of the serving half of ``epropnp_tpu/sixdof/train.py``: the
``Batch`` record and ``build_correspondences`` (dense maps -> point sets +
crop camera). The training step itself is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.pnp import PerspectiveCamera


class Batch(NamedTuple):
    """One batch (tensors on one device, NHWC images)."""
    inp: torch.Tensor          # (bs, 256, 256, 3) normalized rgb crop
    target_coor: torch.Tensor  # (bs, 64, 64, 3) GT noc maps
    loss_msk: torch.Tensor     # (bs, 64, 64, 3) coord-loss mask
    trans_local: torch.Tensor  # (bs, 3) trans-head target [cx_delta, cy_delta, d]
    pose: torch.Tensor         # (bs, 3, 4) GT [R|t]
    c_box: torch.Tensor        # (bs, 2) crop center
    s_box: torch.Tensor        # (bs,) crop scale
    dim: torch.Tensor          # (bs, 3) per-class |min extents|


def build_correspondences(noc, w2d, scale, batch: Batch, cam_intrinsic,
                          out_res: int, sample_inds=None):
    """Dense maps -> (x3d, x2d, w2d) point sets + camera bounds.

    ``noc`` (bs, h, w, 3) and ``w2d`` (bs, h, w, 2) are NHWC;
    ``sample_inds`` (bs, k) selects a point subset (None keeps all
    out_res^2 points, the test path). Returns ``(x3d (bs, n, 3),
    x2d (bs, n, 2), w2d (bs, n, 2), camera)``.
    """
    bs = noc.shape[0]
    if noc.shape[1] != out_res or noc.shape[2] != out_res:
        raise ValueError(
            f'dense map resolution {tuple(noc.shape[1:3])} != cfg '
            f'out_res={out_res}; check DataIterConfig.inp_res/out_res '
            'against the batch images')
    x3d = noc * batch.dim[:, None, None, :]                    # (bs, h, w, 3)

    s = torch.floor(batch.s_box)  # the reference casts to int64
    wh_begin = batch.c_box - s[:, None] / 2.0                  # (bs, 2)
    wh_unit = s / out_res                                      # (bs,)

    wh_arange = torch.arange(out_res, dtype=noc.dtype, device=noc.device)
    y, x = torch.meshgrid(wh_arange, wh_arange, indexing='ij')
    x2d = torch.stack(
        [wh_begin[:, 0, None, None] + x * wh_unit[:, None, None],
         wh_begin[:, 1, None, None] + y * wh_unit[:, None, None]],
        -1)                                                    # (bs, h, w, 2)

    n = out_res * out_res
    x3d = x3d.reshape(bs, n, 3)
    x2d = x2d.reshape(bs, n, 2)
    w2d = w2d.reshape(bs, n, 2)
    if sample_inds is not None:
        take = lambda a: torch.take_along_dim(  # noqa: E731
            a, sample_inds[..., None], 1)
        x3d, x2d, w2d = take(x3d), take(x2d), take(w2d)
        n = sample_inds.shape[1]

    # legacy softmax: exp(w2d - mean - log N) * scale
    w2d = torch.exp(w2d - w2d.mean(1, keepdim=True) - math.log(n)) \
        * scale[:, None, :]

    allowed_border = 30.0 * wh_unit
    camera = PerspectiveCamera(
        cam_mats=torch.as_tensor(cam_intrinsic, dtype=noc.dtype,
                                 device=noc.device).expand(bs, 3, 3),
        z_min=0.01,
        lb=wh_begin - allowed_border[:, None],
        ub=wh_begin + (out_res - 1) * wh_unit[:, None]
        + allowed_border[:, None])
    return x3d, x2d, w2d, camera
