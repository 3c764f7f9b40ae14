"""High-level Det-suite API (PyTorch): build, initialise and run the
detector. Counterpart of ``epropnp_tpu/det/api.py`` (``build_detector``,
``init_detector``, ``inference_detector`` without TTA). Loading a
checkpoint is not ported yet; ``utils.convert.det_state_dict`` maps the
JAX package's variables onto the port's state dict.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.detectors.epropnp_det import EProPnPDet
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


def init_detector(cfg: DetConfig, checkpoint: Optional[str] = None,
                  device=None, **overrides) -> EProPnPDet:
    """Build the model in eval mode with channels-last weights, on the
    CUDA card unless ``device`` says otherwise (the tests pass the CPU).
    Its weights are torch's default initialisation (seed with
    ``torch.manual_seed``).

    The parameters stay f32 under the bf16 serving options. On the card,
    serve with ``torch.backends.cudnn.benchmark = True`` and
    ``torch.backends.cudnn.benchmark_limit = 0``: cuDNN's default f32
    heuristics run several of this model's 3x3 convolutions at a batch of
    6 frames as FFT tiling, up to ~400 ms per call against ~1 ms for the
    algorithm an exhaustive search finds (``chip_smoke.py`` phase g).
    """
    if checkpoint:
        raise NotImplementedError(
            'loading a checkpoint is not ported yet: map JAX variables with '
            'utils.convert.det_state_dict and load_state_dict')
    device = torch.device('cuda' if device is None else device)
    model = build_detector(cfg, **overrides)
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
    """
    if tta:
        raise NotImplementedError('flip TTA is not ported yet')
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
        infer_fn = dtest.make_inference_fn(model, cfg)
    results = infer_fn(
        t(stack('img')), t(stack('cam_intrinsic')),
        t([s['img_shape'] for s in samples]),
        t([s['ori_shape'] for s in samples]),
        t([s['flip'] for s in samples], torch.bool),
        t(stack('img_dense_x2d')), t(stack('img_dense_x2d_mask')), rng=rng)
    return dtest.results_to_numpy(results, len(samples), cfg.num_classes)
