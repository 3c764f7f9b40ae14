"""Typed configuration for the 6DoF suite (PyTorch port).

A copy of ``epropnp_tpu/sixdof/config.py``, so that the port never imports
the JAX package: frozen dataclasses in place of the reference's
argparse+YAML-on-EasyDict system; the four released experiment configs map
onto factory classmethods.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    arch: str = 'resnet'
    back_layers_num: int = 34
    rot_output_channels: int = 5
    back_freeze: bool = False
    rot_head_freeze: bool = False
    trans_head_freeze: bool = False
    # Mixed precision: backbone convs in bfloat16, heads/PnP in float32.
    bf16_backbone: bool = False
    # Rematerialize the CDPN forward in the training backward pass:
    # drops the backbone/head activations from device memory at the cost
    # of one extra forward. Opt-in.
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    # Reference defaults: lib/config.py:87-97 + exps_cfg yamls.
    rot_loss_type: str = 'L1'
    rot_loss_weight: float = 1.0
    trans_loss_type: str = 'L2'
    trans_loss_weight: float = 1.0
    mc_loss_weight: float = 0.02
    t_loss_weight: float = 0.0
    r_loss_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    begin_epoch: int = 0
    end_epoch: int = 160
    train_batch_size: int = 32
    lr_backbone: float = 1e-4
    lr_rot_head: float = 1e-4
    lr_trans_head: float = 1e-4
    lr_epoch_step: Tuple[int, ...] = (50, 100, 150)
    lr_factor: float = 0.1
    optimizer_name: str = 'RMSProp'
    momentum: float = 0.0
    alpha: float = 0.99
    epsilon: float = 1e-8
    # None = reference behavior (no clipping, NaN-skip only); a float
    # enables global-norm gradient clipping.
    clip_grad_norm: Optional[float] = None
    # Cap on the learned correspondence-weight scale (the reference's
    # exp() scale branch is unbounded — resnet_rot_head.py:78 — which
    # can run away on easy data: cost ~ scale^2 x residual^2 overflows,
    # gradients hit inf, and the NaN-skip then freezes training
    # permanently). None = reference behavior.
    w2d_scale_max: Optional[float] = None
    weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class DataIterConfig:
    inp_res: int = 256
    out_res: int = 64
    # training samples 1/8 of the 64x64 dense points
    sample_points: int = 64 * 64 // 8


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    # Training solver (reference lib/train.py:47-57)
    mc_samples: int = 512
    num_iter: int = 4
    lm_num_iter: int = 5
    rs_num_points: int = 16
    rs_num_proposals: int = 4
    rs_num_iter: int = 3
    relative_delta: float = 0.1
    z_min: float = 0.01
    # Test refiner (reference lib/test.py:91-96): GN fast mode
    test_lm_num_iter: int = 3
    # Route LM solves through the fused PnP kernels (ops/pnp/lm_kernel.py,
    # rslm_kernel.py): the CUDA kernels on CUDA tensors, their torch twins
    # on CPU tensors.
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class SixDoFConfig:
    exp_id: str = 'epropnp_basic'
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    dataiter: DataIterConfig = dataclasses.field(
        default_factory=DataIterConfig)
    pnp: PnPConfig = dataclasses.field(default_factory=PnPConfig)
    load_model: Optional[str] = None

    @classmethod
    def epropnp_basic(cls):
        """Scratch training, trans head active, mc weight 0.02."""
        return cls(exp_id='epropnp_basic')

    @classmethod
    def epropnp_reg_loss(cls):
        """+ derivative regularization losses on pose_opt_plus."""
        return cls(
            exp_id='epropnp_reg_loss',
            loss=LossConfig(t_loss_weight=0.1, r_loss_weight=0.1))

    @classmethod
    def epropnp_cdpn_init(cls, ckpt: str):
        return cls(exp_id='epropnp_cdpn_init', load_model=ckpt)

    @classmethod
    def epropnp_cdpn_init_long(cls, ckpt: str):
        return cls(
            exp_id='epropnp_cdpn_init_long', load_model=ckpt,
            train=TrainConfig(end_epoch=320, lr_epoch_step=(100, 200, 300)))
