"""JAX-package CDPN parameters -> the port's ``state_dict``.

``cdpn_state_dict`` is the exact inverse of
``epropnp_tpu/utils/torch_convert.py::cdpn_variables``: it takes the flax
variables of ``epropnp_tpu.models.cdpn.CDPN`` as nested dicts of numpy
arrays (``{'params': ..., 'batch_stats': ...}``) and returns the state
dict of :class:`epropnp_tpu_torch.models.cdpn.CDPN`, whose keys are the
reference checkpoint's. Layout rules (the converter's, reversed):

- Conv kernel (kH, kW, I, O)          -> Conv2d weight (O, I, kH, kW)
- ConvTranspose kernel (kH, kW, I, O) -> ConvTranspose2d weight
  (I, O, kH, kW) with the taps spatially flipped back
- Dense kernel (I, O)                 -> Linear weight (O, I); the trans
  head's first Dense has its rows permuted from the NHWC flatten (H, W, C)
  to the NCHW flatten (C, H, W)
- BatchNorm scale/bias, mean/var      -> weight/bias, running_mean/var

Pure numpy until the final conversion to tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.backbones.resnet import resnet_spec


def conv_weight(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))


def conv_transpose_weight(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def linear_weight(kernel: np.ndarray) -> np.ndarray:
    return kernel.T


def _bn(out: Dict, name: str, params: Dict, stats: Dict) -> None:
    out[f'{name}.weight'] = params['scale']
    out[f'{name}.bias'] = params['bias']
    out[f'{name}.running_mean'] = stats['mean']
    out[f'{name}.running_var'] = stats['var']
    out[f'{name}.num_batches_tracked'] = np.zeros((), np.int64)


def _backbone(out: Dict, params: Dict, stats: Dict, depth: int) -> None:
    block_name, stage_sizes, _ = resnet_spec[depth]
    out['backbone.conv1.weight'] = conv_weight(params['conv1']['kernel'])
    _bn(out, 'backbone.bn1', params['bn1'], stats['bn1'])
    n_convs = 2 if block_name == 'basic' else 3
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for i in range(n_blocks):
            t = f'backbone.layer{stage}.{i}'
            bp = params[f'layer{stage}_block{i}']
            bs = stats[f'layer{stage}_block{i}']
            for j in range(n_convs):
                out[f'{t}.conv{j + 1}.weight'] = conv_weight(
                    bp[f'Conv_{j}']['kernel'])
                _bn(out, f'{t}.bn{j + 1}', bp[f'BatchNorm_{j}'],
                    bs[f'BatchNorm_{j}'])
            if 'downsample_conv' in bp:
                out[f'{t}.downsample.0.weight'] = conv_weight(
                    bp['downsample_conv']['kernel'])
                ds = f'BatchNorm_{n_convs}'
                _bn(out, f'{t}.downsample.1', bp[ds], bs[ds])


def _rot_head(out: Dict, params: Dict, stats: Dict,
              num_layers: int = 3) -> None:
    p = 'rot_head_net.'
    for i in range(num_layers):
        out[f'{p}features.{9 * i}.weight'] = conv_transpose_weight(
            params[f'ConvTranspose_{i}']['kernel'])
        for j, t_idx in enumerate((9 * i + 1, 9 * i + 4, 9 * i + 7)):
            name = f'BatchNorm_{3 * i + j}'
            _bn(out, f'{p}features.{t_idx}', params[name], stats[name])
        out[f'{p}features.{9 * i + 3}.weight'] = conv_weight(
            params[f'Conv_{2 * i}']['kernel'])
        out[f'{p}features.{9 * i + 6}.weight'] = conv_weight(
            params[f'Conv_{2 * i + 1}']['kernel'])
    out[f'{p}out_layer.weight'] = conv_weight(params['out_layer']['kernel'])
    out[f'{p}out_layer.bias'] = params['out_layer']['bias']
    out[f'{p}scale_branch.weight'] = linear_weight(
        params['scale_branch']['kernel'])
    out[f'{p}scale_branch.bias'] = params['scale_branch']['bias']


def _trans_head(out: Dict, params: Dict, stats: Dict, num_layers: int = 3,
                feat_hw: Optional[Tuple[int, int]] = None) -> None:
    p = 'trans_head_net.'
    for i in range(num_layers):
        out[f'{p}features.{3 * i}.weight'] = conv_weight(
            params[f'Conv_{i}']['kernel'])
        name = f'BatchNorm_{i}'
        _bn(out, f'{p}features.{3 * i + 1}', params[name], stats[name])
    lin0 = params['Dense_0']['kernel']                   # (H*W*C, hidden)
    c = params[f'Conv_{num_layers - 1}']['kernel'].shape[-1]
    if feat_hw is None:
        side = math.isqrt(lin0.shape[0] // c)
        feat_hw = (side, side)
    h, w = feat_hw
    lin0 = lin0.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(h * w * c,
                                                                  -1)
    out[f'{p}linears.0.weight'] = linear_weight(lin0)
    out[f'{p}linears.0.bias'] = params['Dense_0']['bias']
    out[f'{p}linears.2.weight'] = linear_weight(params['Dense_1']['kernel'])
    out[f'{p}linears.2.bias'] = params['Dense_1']['bias']
    out[f'{p}linears.4.weight'] = linear_weight(params['Dense_2']['kernel'])
    out[f'{p}linears.4.bias'] = params['Dense_2']['bias']


def cdpn_state_dict(variables: Dict, depth: int = 34,
                    feat_hw: Optional[Tuple[int, int]] = None
                    ) -> Dict[str, torch.Tensor]:
    """flax CDPN variables (numpy) -> port ``CDPN`` state dict (tensors).

    ``feat_hw`` is the backbone feature size (input / 32); None infers a
    square one from the trans head's first Dense.
    """
    params, stats = variables['params'], variables['batch_stats']
    out: Dict[str, np.ndarray] = {}
    _backbone(out, params['backbone'], stats['backbone'], depth)
    _rot_head(out, params['rot_head'], stats['rot_head'])
    _trans_head(out, params['trans_head'], stats['trans_head'],
                feat_hw=feat_hw)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}
