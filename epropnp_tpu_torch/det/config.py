"""Typed configuration for the Det suite (a copy of
``epropnp_tpu/det/config.py``, which the port does not import).

Mirrors the released mmcv config files
(EPro-PnP-Det/configs/epropnp_det_basic.py and the v1b variants) as frozen
dataclasses; ``basic()`` / ``v1b()`` factories reproduce the two published
generations. ``v1b_serving()`` turns on the serving options
(``bf16_*``, ``int8_dcn_gather``, ``level_packed_towers`` and the fused
kernels), which ``det.api.build_detector`` maps onto the model.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DetPnPConfig:
    mc_samples: int = 512
    num_iter: int = 4
    normalize: bool = True
    lm_num_iter: int = 10
    test_lm_num_iter: int = 5   # override_cfg at eval (basic.py:153)
    rs_num_points: int = 16
    rs_num_proposals: int = 64
    rs_num_iter: int = 3
    relative_delta: float = 0.5
    # Route LM solves through the fused kernel K1 (ops/pnp/lm_kernel.py):
    # the CUDA kernel on CUDA tensors, its torch twin on CPU tensors.
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class DetLossWeights:
    pose: float = 0.15
    proj: float = 0.5
    dim: float = 1.0
    regr: float = 0.25          # 0 disables (basic has no coord regr)
    score: float = 1.0
    reg_pos: float = 0.05
    reg_orient: float = 0.05
    velo: float = 0.05
    attr: float = 0.5
    regr_beta: float = 0.05
    reg_pos_beta: float = 1.0


@dataclasses.dataclass(frozen=True)
class DetTrainConfig:
    num_obj_samples_per_img: int = 48
    uniform_mix_ratio: float = 0.5
    roi_shape: Tuple[int, int] = (28, 28)
    max_gt_per_img: int = 32
    # Reference optimizer recipe (configs/epropnp_det_basic.py:226-241):
    # AdamW lr 1e-4 / wd 1e-4, step-LR x0.1 after epochs [10, 11],
    # sampling_offsets param group at lr_mult 0.1, grad clip max_norm 5.
    lr: float = 1e-4
    weight_decay: float = 0.0001
    grad_clip: float = 5.0
    lr_steps: Tuple[int, ...] = (10, 11)
    lr_gamma: float = 0.1
    sampling_offsets_lr_mult: float = 0.1
    epochs: int = 12
    batch_size: int = 12
    # Annotation split: 'train' or 'trainval' (reference trainval configs
    # pass both pickles as ann_file — coord_regr_trainval.py:206-207).
    split: str = 'train'


@dataclasses.dataclass(frozen=True)
class DetConfig:
    num_classes: int = 10
    backbone_depth: int = 101
    embed_dims: int = 256
    num_heads: int = 8
    num_points: int = 32
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64, 128)
    output_stride: int = 4
    use_cls_emb: bool = False
    dim_cls_agnostic: bool = False
    offset_cls_agnostic: bool = True
    pred_velo: bool = True
    pred_attr: bool = True
    num_attrs: int = 9
    score_type: str = 'te'
    with_loss_regr: bool = False
    # DCN sigmoid-mask multiplier: 2.0 = identity-like zero init for
    # from-scratch training; 1.0 = mmcv DCNv2 exactly — required when
    # ingesting converted torch checkpoints (utils/torch_convert).
    dcn_modulation_scale: float = 2.0
    # A bias on every deformable conv (backbone and FCOS towers). False is
    # mmcv's layout (released checkpoints load with strict=True); the flax
    # DeformConv always has one, and a JAX-trained tree needs True
    # (utils.convert.flax_tree_has_dcn_bias tells).
    dcn_bias: bool = False
    # Mixed precision: backbone + FPN in bfloat16, heads/PnP in float32.
    bf16_backbone: bool = False
    # Serving mixed precision: run the head's dense stage (FCOS towers
    # incl. their DCN last convs + dense key/value convs) in bfloat16;
    # scores/centers/key/value are cast back to float32. Opt-in.
    bf16_dense: bool = False
    # Serving-only: int8-quantize the DCN patch-row gather tables
    # (per-channel scales folded into the conv kernels) to halve the
    # gathered bytes of the HBM-bound DCN sampling. Forward-only — keep
    # False for training. Opt-in.
    int8_dcn_gather: bool = False
    # Pack all pyramid levels into one composite canvas for the FCOS
    # towers/branches so each conv runs once at an MXU-friendly shape
    # (the three coarsest serving maps are <= 21x50 — too small to tile
    # the 128x128 MXU; the tower stage measured 9.7% MFU per-level).
    # Output-identical (tests/test_level_pack.py). Opt-in.
    level_packed_towers: bool = False
    # Rematerialize the dense forward (backbone + FPN + FCOS towers +
    # dense key/value) in the training backward pass (jax.checkpoint):
    # trades one extra dense forward for dropping its activations from
    # HBM — the lever that fits the reference's published 6 img/device
    # training batch (configs/epropnp_det_v1b_220411.py, 2 GPU x 6 img)
    # on a single 16G chip. Opt-in.
    remat_dense: bool = False
    pnp: DetPnPConfig = dataclasses.field(default_factory=DetPnPConfig)
    loss: DetLossWeights = dataclasses.field(default_factory=DetLossWeights)
    train: DetTrainConfig = dataclasses.field(default_factory=DetTrainConfig)

    @classmethod
    def basic(cls):
        """epropnp_det_basic: R101-DCN, N=8x32, mc 512."""
        return cls()

    @classmethod
    def coord_regr(cls):
        """epropnp_det_coord_regr: + auxiliary x3d regression loss."""
        return cls(with_loss_regr=True)

    @classmethod
    def coord_regr_trainval(cls):
        """epropnp_det_coord_regr_trainval: coord_regr trained on
        train+val annotations (configs/epropnp_det_coord_regr_trainval.py
        — identical model config; only ``ann_file`` gains the val split).
        """
        return cls(with_loss_regr=True,
                   train=DetTrainConfig(split='trainval'))

    @classmethod
    def no_reproj(cls):
        """epropnp_det_no_reproj ablation: auxiliary reprojection NLL off
        (configs/epropnp_det_no_reproj.py:120 ``loss_proj=None``)."""
        return cls(loss=DetLossWeights(proj=0.0))

    @classmethod
    def v1b(cls):
        """v1b_220411: strides from 8, N=8x16, mc 128, cls embeddings,
        pose loss weight 0.5 (configs/epropnp_det_v1b_220411.py:119)."""
        return cls(
            strides=(8, 16, 32, 64, 128),
            output_stride=8,
            num_points=16,
            use_cls_emb=True,
            dim_cls_agnostic=False,
            offset_cls_agnostic=False,
            pnp=DetPnPConfig(mc_samples=128),
            loss=DetLossWeights(pose=0.5),
            train=DetTrainConfig(roi_shape=(14, 14)))

    @classmethod
    def v1b_serving(cls):
        """v1b with every serving-side TPU optimization enabled: bf16
        backbone+dense, fused Pallas PnP kernels, level-packed FCOS
        towers, int8 DCN gather tables. Numerics: head/PnP stay f32;
        int8 affects only the DCN sampling reads (<1% contraction
        error, tests/test_int8_dcn.py). NOT for training (int8 path is
        forward-only)."""
        base = cls.v1b()
        return dataclasses.replace(
            base, bf16_backbone=True, bf16_dense=True,
            level_packed_towers=True, int8_dcn_gather=True,
            pnp=dataclasses.replace(base.pnp, use_pallas=True))

    @classmethod
    def smoke(cls):
        """CI smoke model: tiny backbone/head/solver so the full CLI
        path (converter pickles -> dataset -> train -> eval ->
        submission) runs in minutes on CPU. NOT a training recipe."""
        return cls(
            backbone_depth=18,
            embed_dims=32,
            num_heads=4,
            num_points=4,
            strides=(8, 16, 32),
            output_stride=8,
            pnp=DetPnPConfig(mc_samples=16, num_iter=2, lm_num_iter=2,
                             rs_num_points=8, rs_num_proposals=4,
                             rs_num_iter=1),
            train=DetTrainConfig(num_obj_samples_per_img=4,
                                 roi_shape=(8, 8), max_gt_per_img=8,
                                 batch_size=2, epochs=1))

    @classmethod
    def v1b_220312(cls):
        """v1b_220312: v1b geometry (strides from 8, N=8x16, RoI 14x14)
        but mc 512, pose weight 0.15, and no class embeddings
        (configs/epropnp_det_v1b_220312.py vs _220411 diff)."""
        return cls(
            strides=(8, 16, 32, 64, 128),
            output_stride=8,
            num_points=16,
            train=DetTrainConfig(roi_shape=(14, 14)))
