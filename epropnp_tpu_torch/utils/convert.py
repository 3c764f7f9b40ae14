"""JAX-package parameters -> the port's ``state_dict``.

``cdpn_state_dict`` and ``det_state_dict`` are the exact inverses of
``epropnp_tpu/utils/torch_convert.py::cdpn_variables`` and
``::det_model_variables``; ``cdpn_variables`` and ``det_variables`` map
the port's CDPN and EProPnPDet states back to the flax names (a training
state, or its gradients, compared with the JAX package's). The first two
take the flax variables of the JAX models as nested dicts of numpy arrays
(``{'params': ..., 'batch_stats': ...}``) and return the state dicts of
the port's ``CDPN`` and ``EProPnPDet``, whose keys are the reference
checkpoints'. Layout rules (the converter's, reversed):

- Conv kernel (kH, kW, I, O)          -> Conv2d weight (O, I, kH, kW)
- ConvTranspose kernel (kH, kW, I, O) -> ConvTranspose2d weight
  (I, O, kH, kW) with the taps spatially flipped back
- Dense kernel (I, O)                 -> Linear weight (O, I); the trans
  head's first Dense has its rows permuted from the NHWC flatten (H, W, C)
  to the NCHW flatten (C, H, W)
- BatchNorm scale/bias, mean/var      -> weight/bias, running_mean/var
- GroupNorm/LayerNorm scale/bias      -> weight/bias
- DeformConv kernel (9 I, O), tap-major -> weight (O, I, 3, 3); its
  conv_offset's (dx, dy) output pairs swapped back to mmcv's (dy, dx);
  the flax bias is kept with ``DetConfig.dcn_bias`` and dropped without
  it, where it must then be zero (mmcv's DCNs have none)
- the q/k/v Dense layers of a point transformer -> one packed
  ``in_proj_weight`` (3E, E) with rows [q; k; v]
- a bf16 leaf (a ``DeformConv`` kernel and bias of a bf16 module, as in
  ``v1b_serving``) -> f32, which is exact: the port's parameters are f32

Pure numpy until the final conversion to tensors.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
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


def _backbone(out: Dict, params: Dict, stats: Dict, depth: int,
              dcn_stages=()) -> None:
    """ResNet convs and BatchNorms; the 3x3 convs of ``dcn_stages`` are
    left to the caller (flax numbers those blocks' convs Conv_0, Conv_1)."""
    block_name, stage_sizes, _ = resnet_spec[depth]
    out['backbone.conv1.weight'] = conv_weight(params['conv1']['kernel'])
    _bn(out, 'backbone.bn1', params['bn1'], stats['bn1'])
    n_convs = 2 if block_name == 'basic' else 3
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for i in range(n_blocks):
            t = f'backbone.layer{stage}.{i}'
            bp = params[f'layer{stage}_block{i}']
            bs = stats[f'layer{stage}_block{i}']
            convs = {1: 'Conv_0', 3: 'Conv_1'} if stage in dcn_stages else {
                j + 1: f'Conv_{j}' for j in range(n_convs)}
            for j, name in convs.items():
                out[f'{t}.conv{j}.weight'] = conv_weight(bp[name]['kernel'])
            for j in range(n_convs):
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


def _flax_bn(params: Dict, stats: Dict, sd: Dict, name: str,
             flax_name: str) -> None:
    params[flax_name] = {'scale': sd[f'{name}.weight'],
                         'bias': sd[f'{name}.bias']}
    if f'{name}.running_mean' in sd:
        stats[flax_name] = {'mean': sd[f'{name}.running_mean'],
                            'var': sd[f'{name}.running_var']}


def cdpn_variables(sd: Dict[str, np.ndarray], depth: int = 34) -> Dict:
    """The port's ``CDPN`` state dict (numpy) -> flax CDPN variables
    ``{'params': ..., 'batch_stats': ...}`` (the inverse of
    :func:`cdpn_state_dict`, and the counterpart of
    ``epropnp_tpu/utils/torch_convert.py::cdpn_variables``). Entries
    without running statistics (a dict of gradients) give no
    ``batch_stats`` for their BatchNorms."""
    block_name, stage_sizes, _ = resnet_spec[depth]
    conv = lambda name: {'kernel': np.ascontiguousarray(  # noqa: E731
        np.transpose(sd[f'{name}.weight'], (2, 3, 1, 0)))}
    dense = lambda name: {'kernel': np.ascontiguousarray(  # noqa: E731
        sd[f'{name}.weight'].T), 'bias': sd[f'{name}.bias']}

    bp, bs = {'conv1': conv('backbone.conv1')}, {}
    _flax_bn(bp, bs, sd, 'backbone.bn1', 'bn1')
    n_convs = 2 if block_name == 'basic' else 3
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for i in range(n_blocks):
            t, f = f'backbone.layer{stage}.{i}', f'layer{stage}_block{i}'
            p, st = {}, {}
            for j in range(n_convs):
                p[f'Conv_{j}'] = conv(f'{t}.conv{j + 1}')
                _flax_bn(p, st, sd, f'{t}.bn{j + 1}', f'BatchNorm_{j}')
            if f'{t}.downsample.0.weight' in sd:
                p['downsample_conv'] = conv(f'{t}.downsample.0')
                _flax_bn(p, st, sd, f'{t}.downsample.1',
                         f'BatchNorm_{n_convs}')
            bp[f], bs[f] = p, st

    rp, rs, h = {}, {}, 'rot_head_net.'
    for i in range(3):
        w = sd[f'{h}features.{9 * i}.weight']
        rp[f'ConvTranspose_{i}'] = {'kernel': np.ascontiguousarray(
            np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)))}
        for j, t_idx in enumerate((9 * i + 1, 9 * i + 4, 9 * i + 7)):
            _flax_bn(rp, rs, sd, f'{h}features.{t_idx}',
                     f'BatchNorm_{3 * i + j}')
        rp[f'Conv_{2 * i}'] = conv(f'{h}features.{9 * i + 3}')
        rp[f'Conv_{2 * i + 1}'] = conv(f'{h}features.{9 * i + 6}')
    rp['out_layer'] = conv(f'{h}out_layer')
    rp['out_layer']['bias'] = sd[f'{h}out_layer.bias']
    rp['scale_branch'] = dense(f'{h}scale_branch')

    tp, ts, h = {}, {}, 'trans_head_net.'
    for i in range(3):
        tp[f'Conv_{i}'] = conv(f'{h}features.{3 * i}')
        _flax_bn(tp, ts, sd, f'{h}features.{3 * i + 1}', f'BatchNorm_{i}')
    lin0 = dense(f'{h}linears.0')
    c = tp['Conv_2']['kernel'].shape[-1]
    side = math.isqrt(lin0['kernel'].shape[0] // c)
    lin0['kernel'] = np.ascontiguousarray(lin0['kernel'].reshape(
        c, side, side, -1).transpose(1, 2, 0, 3).reshape(side * side * c, -1))
    tp['Dense_0'] = lin0
    tp['Dense_1'] = dense(f'{h}linears.2')
    tp['Dense_2'] = dense(f'{h}linears.4')
    return {'params': {'backbone': bp, 'rot_head': rp, 'trans_head': tp},
            'batch_stats': {'backbone': bs, 'rot_head': rs,
                            'trans_head': ts}}


# ------------------------------------------------------------------ Det

_DCN_PAIR_SWAP = [2 * i + (1 - j) for i in range(9) for j in range(2)] \
    + list(range(18, 27))  # (dx, dy) <-> (dy, dx) per tap; an involution


def _conv(out: Dict, name: str, p: Dict) -> None:
    out[f'{name}.weight'] = conv_weight(p['kernel'])
    if 'bias' in p:
        out[f'{name}.bias'] = p['bias']


def _linear(out: Dict, name: str, p: Dict) -> None:
    out[f'{name}.weight'] = linear_weight(p['kernel'])
    out[f'{name}.bias'] = p['bias']


def _norm(out: Dict, name: str, p: Dict) -> None:
    out[f'{name}.weight'] = p['scale']
    out[f'{name}.bias'] = p['bias']


def _deform_conv(out: Dict, name: str, p: Dict, bias: bool) -> None:
    kernel = p['kernel']
    c_in, c_out = kernel.shape[0] // 9, kernel.shape[1]
    out[f'{name}.weight'] = conv_weight(kernel.reshape(3, 3, c_in, c_out))
    if bias:
        out[f'{name}.bias'] = p['bias']
    elif np.any(p['bias']):
        raise ValueError(f'{name}: the flax DeformConv bias is non-zero, but '
                         'the model has none (DetConfig.dcn_bias=False, '
                         "mmcv's layout); build it with dcn_bias=True")
    out[f'{name}.conv_offset.weight'] = conv_weight(
        p['conv_offset']['kernel'])[_DCN_PAIR_SWAP]
    out[f'{name}.conv_offset.bias'] = p['conv_offset']['bias'][_DCN_PAIR_SWAP]


def _dcn_params(tree: Dict):
    """Every flax ``DeformConv`` params dict in ``tree``."""
    for value in tree.values():
        if isinstance(value, Mapping):
            if 'kernel' in value and 'conv_offset' in value:
                yield value
            else:
                yield from _dcn_params(value)


def flax_tree_has_dcn_bias(variables: Dict) -> bool:
    """Whether any flax ``DeformConv`` of an EProPnPDet tree has a non-zero
    bias: the ``DetConfig.dcn_bias`` that :func:`det_state_dict` needs."""
    return any(np.any(np.asarray(p['bias']))
               for p in _dcn_params(variables['params']))


def _det_backbone(out: Dict, params: Dict, stats: Dict,
                  depth: int, dcn_bias: bool = False) -> None:
    """ResNet(-DCN): a stage is deformable where its blocks hold a
    ``DeformConv_0`` (stages 3 and 4 of every released config)."""
    _, stage_sizes, _ = resnet_spec[depth]
    dcn_stages = tuple(s for s in range(1, 5)
                       if 'DeformConv_0' in params[f'layer{s}_block0'])
    _backbone(out, params, stats, depth, dcn_stages)
    for stage in dcn_stages:
        for i in range(stage_sizes[stage - 1]):
            _deform_conv(out, f'backbone.layer{stage}.{i}.conv2',
                         params[f'layer{stage}_block{i}']['DeformConv_0'],
                         bias=dcn_bias)


def _fcos_head(out: Dict, params: Dict, p: str,
               dcn_bias: bool = False) -> None:
    for tower, ours in (('cls_convs', 'cls'), ('reg_convs', 'reg')):
        i = 0
        while f'{ours}_gn{i}' in params:
            t = f'{p}{tower}.{i}'
            if f'{ours}_dcn{i}' in params:
                _deform_conv(out, f'{t}.conv', params[f'{ours}_dcn{i}'],
                             bias=dcn_bias)
            else:
                _conv(out, f'{t}.conv', params[f'{ours}_conv{i}'])
            _norm(out, f'{t}.gn', params[f'{ours}_gn{i}'])
            i += 1
    for torch_br, ours in (('conv_cls_prev', 'cls_br'),
                           ('conv_centerness_prev', 'ctr_br'),
                           ('conv_offset_prev', 'off_br'),
                           ('conv_emb_prev', 'emb_br')):
        j = 0
        while f'{ours}_conv{j}' in params:
            _conv(out, f'{p}{torch_br}.{j}.conv', params[f'{ours}_conv{j}'])
            _norm(out, f'{p}{torch_br}.{j}.gn', params[f'{ours}_gn{j}'])
            j += 1
    for name in ('conv_cls', 'conv_centerness', 'conv_offset'):
        _conv(out, f'{p}{name}', params[name])
    _conv(out, f'{p}conv_emb.conv', params['conv_emb'])
    _norm(out, f'{p}conv_emb.gn', params['conv_emb_gn'])


def _det_head(out: Dict, params: Dict, p: str = 'bbox_head.',
              dcn_bias: bool = False) -> None:
    _fcos_head(out, params['detector'], f'{p}detector.', dcn_bias)
    sampler = params['attention_sampler']
    s = f'{p}attention_sampler.'
    _linear(out, f'{s}sampling_offsets', sampler['sampling_offsets'])
    _linear(out, f'{s}out_proj', sampler['out_proj'])
    _norm(out, f'{s}layer_norms.0', sampler['norm1'])
    _linear(out, f'{s}ffn.layers.0.0', sampler['ffn1'])
    _linear(out, f'{s}ffn.layers.1', sampler['ffn2'])
    _norm(out, f'{s}layer_norms.1', sampler['norm2'])
    _conv(out, f'{p}conv_upsampled.conv', params['conv_upsampled'])
    _norm(out, f'{p}conv_upsampled.gn', params['conv_upsampled_gn'])
    for name in ('k_proj', 'v_proj'):
        _conv(out, f'{p}{name}', params[name])
    out[f'{p}query_scale.scale'] = np.asarray(params['query_scale'])
    for name in ('query_proj', 'dim_branch', 'score_branch', 'scale_branch',
                 'x2d_pos_enc', 'velo_branch', 'attr_branch'):
        if name in params:
            _linear(out, f'{p}{name}', params[name])
    if 'cls_emb' in params:
        out[f'{p}cls_emb'] = params['cls_emb']
    i = 0
    while f'dense_conv{i}' in params:
        _conv(out, f'{p}convs.{i}.conv', params[f'dense_conv{i}'])
        i += 1
    i = 0
    while f'pred_fc{i}' in params:
        _linear(out, f'{p}pred_fc.{2 * i}', params[f'pred_fc{i}'])
        i += 1
    i = 0
    while f'pts_trans{i}' in params:
        tr, t = params[f'pts_trans{i}'], f'{p}pts_trans.{i}.'
        out[f'{p}obj_query_scale.{i}.scale'] = np.asarray(
            params[f'obj_query_scale{i}'])
        qkv = ('q_proj', 'k_proj', 'v_proj')
        out[f'{t}attentions.0.attn.in_proj_weight'] = np.concatenate(
            [linear_weight(tr[n]['kernel']) for n in qkv], 0)
        out[f'{t}attentions.0.attn.in_proj_bias'] = np.concatenate(
            [tr[n]['bias'] for n in qkv], 0)
        _linear(out, f'{t}attentions.0.attn.out_proj', tr['out_proj'])
        _norm(out, f'{t}norms.0', tr['norm1'])
        _linear(out, f'{t}ffns.0.layers.0.0', tr['ffn1'])
        _linear(out, f'{t}ffns.0.layers.1', tr['ffn2'])
        _norm(out, f'{t}norms.1', tr['norm2'])
        i += 1
    i = 0
    while f'corr_reg{i}' in params:
        out[f'{p}corr_regs.{i}.weight'] = params[f'corr_reg{i}']['weight']
        out[f'{p}corr_regs.{i}.bias'] = params[f'corr_reg{i}']['bias']
        i += 1


def det_state_dict(variables: Dict, cfg) -> Dict[str, torch.Tensor]:
    """flax EProPnPDet variables (numpy) -> port ``EProPnPDet`` state dict.

    ``cfg`` is a ``det.config.DetConfig`` (its depth, strides and
    ``dcn_bias``). With ``cfg.dcn_bias`` the flax DCN biases are written;
    without it they must be zero, or this raises (the model has no bias
    to take them: see :func:`flax_tree_has_dcn_bias`).
    """
    params, stats = variables['params'], variables['batch_stats']
    out: Dict[str, np.ndarray] = {}
    _det_backbone(out, params['backbone'], stats['backbone'],
                  cfg.backbone_depth, cfg.dcn_bias)
    neck = params['neck']
    n_lat = sum(k.startswith('lateral_') for k in neck)
    for i in range(n_lat):
        _conv(out, f'neck.lateral_convs.{i}.conv', neck[f'lateral_{i}'])
        _conv(out, f'neck.fpn_convs.{i}.conv', neck[f'fpn_conv_{i}'])
    for j in range(len(cfg.strides) - n_lat):
        _conv(out, f'neck.fpn_convs.{n_lat + j}.conv',
              neck[f'extra_conv_{j}'])
    _det_head(out, params['head'], dcn_bias=cfg.dcn_bias)
    return {k: torch.tensor(_float32_if_bf16(np.asarray(v)))
            for k, v in out.items()}


def _float32_if_bf16(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32) if a.dtype.name == 'bfloat16' else a


def _flax_deform_conv(sd: Dict, name: str) -> Dict:
    """mmcv DCNv2 entries -> flax ``DeformConv`` params: the kernel
    flattened tap-major to (9 I, O), the conv_offset's (dy, dx) output
    pairs swapped to (dx, dy); the module's bias, or zeros where it has
    none (mmcv's layout)."""
    w = sd[f'{name}.weight']
    c_out, c_in = w.shape[:2]
    kernel = np.transpose(w, (2, 3, 1, 0)).reshape(9 * c_in, c_out)
    off_w = sd[f'{name}.conv_offset.weight'][_DCN_PAIR_SWAP]
    return {'kernel': np.ascontiguousarray(kernel),
            'bias': sd.get(f'{name}.bias', np.zeros(c_out, w.dtype)),
            'conv_offset': {
                'kernel': np.ascontiguousarray(
                    np.transpose(off_w, (2, 3, 1, 0))),
                'bias': sd[f'{name}.conv_offset.bias'][_DCN_PAIR_SWAP]}}


def det_variables(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """The port's ``EProPnPDet`` state dict (numpy) -> flax EProPnPDet
    variables ``{'params': ..., 'batch_stats': ...}``, the inverse of
    :func:`det_state_dict` (a training state, or its gradients, compared
    with the JAX package's). ``cfg`` is a ``det.config.DetConfig``.

    The flax ``DeformConv`` always has a bias: a model built with
    ``dcn_bias`` gives its own, one without (mmcv's layout) zeros. Entries
    without running statistics (a dict of gradients) give no
    ``batch_stats`` for their BatchNorms.
    """
    def conv(name, bias=True):
        out = {'kernel': np.ascontiguousarray(
            np.transpose(sd[f'{name}.weight'], (2, 3, 1, 0)))}
        if bias and f'{name}.bias' in sd:
            out['bias'] = sd[f'{name}.bias']
        return out

    def dense(name):
        return {'kernel': np.ascontiguousarray(sd[f'{name}.weight'].T),
                'bias': sd[f'{name}.bias']}

    def norm(name):
        return {'scale': sd[f'{name}.weight'], 'bias': sd[f'{name}.bias']}

    block_name, stage_sizes, _ = resnet_spec[cfg.backbone_depth]
    n_convs = 2 if block_name == 'basic' else 3
    bp, bs = {'conv1': conv('backbone.conv1')}, {}
    _flax_bn(bp, bs, sd, 'backbone.bn1', 'bn1')
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for i in range(n_blocks):
            t, f = f'backbone.layer{stage}.{i}', f'layer{stage}_block{i}'
            p, st = {}, {}
            if f'{t}.conv2.conv_offset.weight' in sd:
                p['Conv_0'] = conv(f'{t}.conv1')
                p['DeformConv_0'] = _flax_deform_conv(sd, f'{t}.conv2')
                p['Conv_1'] = conv(f'{t}.conv3')
            else:
                for j in range(n_convs):
                    p[f'Conv_{j}'] = conv(f'{t}.conv{j + 1}')
            for j in range(n_convs):
                _flax_bn(p, st, sd, f'{t}.bn{j + 1}', f'BatchNorm_{j}')
            if f'{t}.downsample.0.weight' in sd:
                p['downsample_conv'] = conv(f'{t}.downsample.0')
                _flax_bn(p, st, sd, f'{t}.downsample.1',
                         f'BatchNorm_{n_convs}')
            bp[f] = p
            if st:
                bs[f] = st

    neck = {}
    n_lat = sum(k.startswith('neck.lateral_convs.') and k.endswith('.weight')
                for k in sd)
    for i in range(n_lat):
        neck[f'lateral_{i}'] = conv(f'neck.lateral_convs.{i}.conv')
        neck[f'fpn_conv_{i}'] = conv(f'neck.fpn_convs.{i}.conv')
    for j in range(len(cfg.strides) - n_lat):
        neck[f'extra_conv_{j}'] = conv(f'neck.fpn_convs.{n_lat + j}.conv')

    p = 'bbox_head.'
    det, d = {}, f'{p}detector.'
    for tower, ours in (('cls_convs', 'cls'), ('reg_convs', 'reg')):
        i = 0
        while f'{d}{tower}.{i}.gn.weight' in sd:
            t = f'{d}{tower}.{i}'
            if f'{t}.conv.conv_offset.weight' in sd:
                det[f'{ours}_dcn{i}'] = _flax_deform_conv(sd, f'{t}.conv')
            else:
                det[f'{ours}_conv{i}'] = conv(f'{t}.conv', bias=False)
            det[f'{ours}_gn{i}'] = norm(f'{t}.gn')
            i += 1
    for torch_br, ours in (('conv_cls_prev', 'cls_br'),
                           ('conv_centerness_prev', 'ctr_br'),
                           ('conv_offset_prev', 'off_br'),
                           ('conv_emb_prev', 'emb_br')):
        j = 0
        while f'{d}{torch_br}.{j}.conv.weight' in sd:
            det[f'{ours}_conv{j}'] = conv(f'{d}{torch_br}.{j}.conv',
                                          bias=False)
            det[f'{ours}_gn{j}'] = norm(f'{d}{torch_br}.{j}.gn')
            j += 1
    for name in ('conv_cls', 'conv_centerness', 'conv_offset'):
        det[name] = conv(f'{d}{name}')
    det['conv_emb'] = conv(f'{d}conv_emb.conv', bias=False)
    det['conv_emb_gn'] = norm(f'{d}conv_emb.gn')

    s = f'{p}attention_sampler.'
    head = {
        'detector': det,
        'attention_sampler': {
            'sampling_offsets': dense(f'{s}sampling_offsets'),
            'out_proj': dense(f'{s}out_proj'),
            'norm1': norm(f'{s}layer_norms.0'),
            'ffn1': dense(f'{s}ffn.layers.0.0'),
            'ffn2': dense(f'{s}ffn.layers.1'),
            'norm2': norm(f'{s}layer_norms.1')},
        'conv_upsampled': conv(f'{p}conv_upsampled.conv', bias=False),
        'conv_upsampled_gn': norm(f'{p}conv_upsampled.gn'),
        'k_proj': conv(f'{p}k_proj'),
        'v_proj': conv(f'{p}v_proj'),
        'query_scale': sd[f'{p}query_scale.scale'],
    }
    for name in ('query_proj', 'dim_branch', 'score_branch', 'scale_branch',
                 'x2d_pos_enc', 'velo_branch', 'attr_branch'):
        if f'{p}{name}.weight' in sd:
            head[name] = dense(f'{p}{name}')
    if f'{p}cls_emb' in sd:
        head['cls_emb'] = sd[f'{p}cls_emb']
    i = 0
    while f'{p}convs.{i}.conv.weight' in sd:
        head[f'dense_conv{i}'] = conv(f'{p}convs.{i}.conv', bias=False)
        i += 1
    i = 0
    while f'{p}pred_fc.{2 * i}.weight' in sd:
        head[f'pred_fc{i}'] = dense(f'{p}pred_fc.{2 * i}')
        i += 1
    i = 0
    while f'{p}pts_trans.{i}.norms.0.weight' in sd:
        t = f'{p}pts_trans.{i}.'
        head[f'obj_query_scale{i}'] = sd[f'{p}obj_query_scale.{i}.scale']
        w = sd[f'{t}attentions.0.attn.in_proj_weight']
        b = sd[f'{t}attentions.0.attn.in_proj_bias']
        e = w.shape[1]
        tr = {name: {'kernel': np.ascontiguousarray(w[j * e:(j + 1) * e].T),
                     'bias': b[j * e:(j + 1) * e]}
              for j, name in enumerate(('q_proj', 'k_proj', 'v_proj'))}
        tr['out_proj'] = dense(f'{t}attentions.0.attn.out_proj')
        tr['norm1'] = norm(f'{t}norms.0')
        tr['ffn1'] = dense(f'{t}ffns.0.layers.0.0')
        tr['ffn2'] = dense(f'{t}ffns.0.layers.1')
        tr['norm2'] = norm(f'{t}norms.1')
        head[f'pts_trans{i}'] = tr
        i += 1
    i = 0
    while f'{p}corr_regs.{i}.weight' in sd:
        head[f'corr_reg{i}'] = {'weight': sd[f'{p}corr_regs.{i}.weight'],
                                'bias': sd[f'{p}corr_regs.{i}.bias']}
        i += 1
    return {'params': {'backbone': bp, 'neck': neck, 'head': head},
            'batch_stats': {'backbone': bs}}
