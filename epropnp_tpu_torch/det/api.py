"""High-level Det-suite API (PyTorch): build, load and run the detector.
Counterpart of ``epropnp_tpu/det/api.py`` (``build_detector``,
``torch_checkpoint_has_dcn_offsets``, ``load_torch_variables`` as
:func:`load_torch_weights`, ``init_detector``, ``inference_detector`` with
flip TTA).

Weights load from a JAX checkpoint (flax msgpack, read by
``utils.checkpoint.load_jax_variables`` and mapped by
``utils.convert.det_state_dict``) or from a torch file (``.pth``, ``.pt``,
``.tar``): a torchvision ResNet, an mmdet backbone and neck, or a full
EProPnPDet checkpoint. The port's parameter names are mmdet's, so a torch
file's entries load by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.detectors.epropnp_det import EProPnPDet
from ..ops.deform_conv import DeformConv
from ..utils.checkpoint import TORCH_SUFFIXES, load_jax_variables
from ..utils.convert import det_state_dict, flax_tree_has_dcn_bias
from . import test as dtest
from .config import DetConfig
from .pipelines import REFERENCE_CROP_BOX, default_pipeline


def build_detector(cfg: DetConfig, **overrides) -> EProPnPDet:
    """The model of ``cfg``, with its serving options mapped as the JAX API
    maps them (bf16 backbone and dense stage, int8 DCN sampling,
    level-packed towers). ``remat_dense`` and ``score_type`` concern
    training only and change nothing here."""
    return EProPnPDet(
        num_classes=cfg.num_classes, backbone_depth=cfg.backbone_depth,
        embed_dims=cfg.embed_dims, num_heads=cfg.num_heads,
        num_points=cfg.num_points, strides=cfg.strides,
        output_stride=cfg.output_stride, use_cls_emb=cfg.use_cls_emb,
        dim_cls_agnostic=cfg.dim_cls_agnostic,
        offset_cls_agnostic=cfg.offset_cls_agnostic,
        pred_velo=cfg.pred_velo, pred_attr=cfg.pred_attr,
        num_attrs=cfg.num_attrs,
        dcn_modulation_scale=cfg.dcn_modulation_scale,
        dcn_bias=cfg.dcn_bias, dcn_int8_gather=cfg.int8_dcn_gather,
        level_packed_towers=cfg.level_packed_towers,
        backbone_dtype=torch.bfloat16 if cfg.bf16_backbone else None,
        dense_dtype=torch.bfloat16 if cfg.bf16_dense else None, **overrides)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint as a flat state dict of CPU tensors: raw state
    dicts and the ``{'state_dict': ...}`` (mmcv), ``{'model': ...}`` and
    ``{'network': ...}`` wrappers; a ``module.`` (DDP) prefix is removed.
    (A copy of ``epropnp_tpu/utils/torch_convert.py::load_torch_state_dict``
    that keeps tensors.)"""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    for key in ('state_dict', 'model', 'network'):
        if isinstance(obj, dict) and key in obj \
                and isinstance(obj[key], dict):
            obj = obj[key]
            break
    out = {}
    for k, v in obj.items():
        if k.startswith('module.'):
            k = k[len('module.'):]
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
    return out


def torch_checkpoint_has_dcn_offsets(path: str) -> bool:
    """True if a torch checkpoint carries mmcv DCNv2 ``conv_offset`` keys:
    it was trained with mmcv's plain-sigmoid modulation
    (``dcn_modulation_scale=1.0``). A torchvision zoo file has none and
    wants the configured scale, so that the zero-offset graft stays the
    dense convolution."""
    return any('conv_offset' in k for k in load_torch_state_dict(path))


def _torch_source(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The entries of a torch checkpoint under the port's (mmdet's) names:
    a torchvision ResNet (``conv1.weight`` at the top level) is prefixed
    with ``backbone.`` (its ``fc`` dropped); an mmdet file keeps its
    ``backbone.``, ``neck.`` and ``bbox_head.`` entries."""
    if 'backbone.conv1.weight' in sd or any(
            k.startswith(('neck.', 'bbox_head.')) for k in sd):
        return {k: v for k, v in sd.items()
                if k.startswith(('backbone.', 'neck.', 'bbox_head.'))}
    if 'conv1.weight' in sd:
        return {f'backbone.{k}': v for k, v in sd.items()
                if not k.startswith('fc.')}
    return {}


def load_torch_weights(model: EProPnPDet, cfg: DetConfig, path: str
                       ) -> EProPnPDet:
    """Load a torch checkpoint into ``model`` in place and return it (the
    counterpart of ``load_torch_variables``). Its three sources:

    * a torchvision ImageNet ResNet (``conv1.weight`` at the top level),
      the reference's ``init_cfg=Pretrained torchvision://resnet101``: the
      3x3 kernels of the DCN stages become the DCN weights, with
      ``conv_offset`` (and a DCN bias, if the model has one) at zero, as
      mmcv initialises it;
    * an mmdet backbone and neck (``backbone.`` / ``neck.``);
    * a full EProPnPDet checkpoint (and ``bbox_head.``); build the model
      with ``dcn_modulation_scale=1.0`` (``init_detector`` does).

    Entries the model lacks are ignored; parameters the file lacks keep
    their values (filtered restore). A shape mismatch, or a file with no
    recognisable key, raises ``ValueError``.
    """
    sd = load_torch_state_dict(path)
    if any('conv_offset' in k for k in sd) \
            and cfg.dcn_modulation_scale != 1.0:
        raise ValueError(
            f'{path} carries mmcv DCNv2 conv_offset weights but the model '
            f'was built with dcn_modulation_scale={cfg.dcn_modulation_scale}'
            ' — every DCN mask would be silently rescaled. Rebuild with '
            'dcn_modulation_scale=1.0 (init_detector does this '
            'automatically).')
    src = _torch_source(sd)
    if not src:
        raise ValueError(
            f'{path}: no recognizable backbone/neck/head keys '
            '(expected torchvision or mmdet EPro-PnP-Det naming)')
    current = model.state_dict()
    for name, mod in model.named_modules():
        if isinstance(mod, DeformConv) and f'{name}.weight' in src \
                and f'{name}.conv_offset.weight' not in src:
            # a plain 3x3 conv grafted into a DCN: zero offsets and mask
            # logits (mmcv's init), so it starts as that convolution
            for key in ('conv_offset.weight', 'conv_offset.bias', 'bias'):
                if f'{name}.{key}' in current and f'{name}.{key}' not in src:
                    src[f'{name}.{key}'] = torch.zeros_like(
                        current[f'{name}.{key}'])
    matched = 0
    for key, value in src.items():
        if key not in current:
            continue
        if tuple(value.shape) != tuple(current[key].shape):
            raise ValueError(
                f'shape mismatch at {key}: checkpoint {tuple(value.shape)} '
                f'vs model {tuple(current[key].shape)}')
        current[key] = value.to(current[key].dtype)
        matched += 1
    if not matched:
        raise ValueError(f'{path}: no entry matches the model')
    model.load_state_dict(current)
    return model


def init_detector(cfg: DetConfig, checkpoint: Optional[str] = None,
                  device=None, **overrides) -> EProPnPDet:
    """Build the model in eval mode with channels-last weights, on the
    CUDA card unless ``device`` says otherwise (the tests pass the CPU),
    and load ``checkpoint`` if given: a torch ``.pth/.pt/.tar`` file
    (:func:`load_torch_weights`) or a JAX checkpoint in flax msgpack (a
    variables or train-state file of the JAX package). Without a
    checkpoint the weights are torch's default initialisation (seed with
    ``torch.manual_seed``).

    A torch file with mmcv DCN offsets builds the model with
    ``dcn_modulation_scale=1.0`` (mmcv's plain-sigmoid modulation); a JAX
    tree whose DCNs have a non-zero bias builds it with
    ``DetConfig.dcn_bias`` (``utils.convert.flax_tree_has_dcn_bias``).

    The parameters stay f32 under the bf16 serving options. On the card,
    serve with ``torch.backends.cudnn.benchmark = True`` and
    ``torch.backends.cudnn.benchmark_limit = 0``: cuDNN's default f32
    heuristics run several of this model's 3x3 convolutions at a batch of
    6 frames as FFT tiling, up to ~400 ms per call against ~1 ms for the
    algorithm an exhaustive search finds (``chip_smoke.py`` phase g).
    """
    device = torch.device('cuda' if device is None else device)
    variables = None
    if checkpoint and checkpoint.endswith(TORCH_SUFFIXES):
        if cfg.dcn_modulation_scale != 1.0 \
                and torch_checkpoint_has_dcn_offsets(checkpoint):
            cfg = dataclasses.replace(cfg, dcn_modulation_scale=1.0)
    elif checkpoint:
        variables = load_jax_variables(checkpoint)
        if flax_tree_has_dcn_bias(variables) and not cfg.dcn_bias:
            cfg = dataclasses.replace(cfg, dcn_bias=True)
    model = build_detector(cfg, **overrides)
    if variables is not None:
        model.load_state_dict(det_state_dict(variables, cfg), strict=True)
    elif checkpoint:
        load_torch_weights(model, cfg, checkpoint)
    return model.to(device, memory_format=torch.channels_last).eval()


def inference_detector(model: EProPnPDet, cfg: DetConfig,
                       imgs: List[np.ndarray],
                       cam_intrinsics: List[np.ndarray], infer_fn=None,
                       rng: Optional[torch.Generator] = None,
                       crop_box='auto', tta: bool = False):
    """Raw images (h, w, 3) -> per-image per-class detection arrays.

    ``crop_box='auto'`` applies the reference sky-band crop
    (``REFERENCE_CROP_BOX``: 1600x900 -> 1600x672) when the frame is at
    least that large; None disables it, or pass a box. The host pipeline
    runs in numpy; the model, the solve and the NMS on the model's device.
    ``tta`` runs the horizontal-flip test-time augmentation
    (``det.test.make_tta_inference_fn``): the images and x2d maps are
    flipped along their width on the device, as the JAX API flips them.
    """
    samples = []
    for img, k in zip(imgs, cam_intrinsics):
        box = crop_box
        if box == 'auto':
            box = REFERENCE_CROP_BOX if (
                img.shape[0] >= REFERENCE_CROP_BOX[3]
                and img.shape[1] >= REFERENCE_CROP_BOX[2]) else None
        samples.append(default_pipeline(
            dict(img=img, cam_intrinsic=np.asarray(k)), crop_box=box))
    device = next(model.parameters()).device
    t = lambda a, dtype=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dtype).to(device)
    stack = lambda key: np.stack([s[key] for s in samples])  # noqa: E731
    if infer_fn is None:
        infer_fn = (dtest.make_tta_inference_fn if tta
                    else dtest.make_inference_fn)(model, cfg)
    img, x2d = t(stack('img')), t(stack('img_dense_x2d'))
    cam = t(stack('cam_intrinsic'))
    shapes = t([s['img_shape'] for s in samples])
    ori = t([s['ori_shape'] for s in samples])
    x2d_mask = t(stack('img_dense_x2d_mask'))
    if tta:
        results = infer_fn(img, torch.flip(img, [2]), cam, shapes, ori, x2d,
                           torch.flip(x2d, [2]), x2d_mask, rng=rng)
    else:
        results = infer_fn(img, cam, shapes, ori,
                           t([s['flip'] for s in samples], torch.bool), x2d,
                           x2d_mask, rng=rng)
    return dtest.results_to_numpy(results, len(samples), cfg.num_classes)
