"""Deformable attention sampler (PyTorch), counterpart of
``epropnp_tpu/ops/deformable_attention.py``.

Per object: predict ``num_heads x num_points`` 2D offsets from the object
embedding, bilinearly sample key/value/x2d/mask maps at
``center + offset * stride``, attend ``softmax(q.k / sqrt(d)) * mask``, and
update the object embedding with out-proj + LayerNorm + FFN residual.
Submodules carry the reference's names (``sampling_offsets``,
``out_proj``, ``layer_norms.{0,1}``, ``ffn.layers.0.0``/``ffn.layers.1``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from .bilinear_sample import batched_bilinear_sample


class SamplerOutputs(NamedTuple):
    output: torch.Tensor        # (num_obj, embed_dims)
    v_samples: torch.Tensor     # (num_obj, heads, head_dim, num_points)
    a_samples: torch.Tensor     # (num_obj, heads, 1, num_points)
    mask_samples: torch.Tensor  # (num_obj, heads, 1, num_points)
    x2d_samples: torch.Tensor   # (num_obj, heads, 2, num_points)


def ffn(embed_dims: int, hidden: int) -> nn.Module:
    """mmcv FFN layout: ``layers.0.0`` Linear + ReLU, ``layers.1`` Linear."""
    mod = nn.Module()
    mod.layers = nn.Sequential(
        nn.Sequential(nn.Linear(embed_dims, hidden), nn.ReLU()),
        nn.Linear(hidden, embed_dims))
    return mod


class DeformableAttentionSampler(nn.Module):
    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_points: int = 32, stride: int = 4, ffn_dim: int = 1024):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_points, self.stride = num_points, stride
        self.sampling_offsets = nn.Linear(embed_dims,
                                          num_heads * num_points * 2)
        self.out_proj = nn.Linear(embed_dims, embed_dims)
        self.layer_norms = nn.ModuleList(
            [nn.LayerNorm(embed_dims, eps=1e-5) for _ in range(2)])
        self.ffn = ffn(embed_dims, ffn_dim)

    def forward(self, query, obj_emb, key, value, img_dense_x2d,
                img_dense_x2d_mask, obj_xy_point, strides,
                obj_img_ind) -> SamplerOutputs:
        """query (num_obj, heads, 1, head_dim); obj_emb (num_obj, embed);
        key/value (num_img, h, w, embed) NHWC; img_dense_x2d (num_img, h, w,
        2) and its mask (.., 1); obj_xy_point (num_obj, 2) image pixels;
        strides (num_obj,); obj_img_ind (num_obj,) int."""
        num_obj = query.shape[0]
        head_dim = self.embed_dims // self.num_heads
        offsets = self.sampling_offsets(obj_emb).reshape(
            num_obj, self.num_heads, self.num_points, 2)
        loc = obj_xy_point[:, None, None] + offsets * strides[:, None, None,
                                                              None]
        feat_xy = loc / self.stride - 0.5  # align_corners=False convention

        # head h samples its own channel slice at its own locations
        k_heads, v_heads = [], []
        for h in range(self.num_heads):
            sl = slice(h * head_dim, (h + 1) * head_dim)
            k_heads.append(batched_bilinear_sample(
                key[..., sl], obj_img_ind, feat_xy[:, h], 'border'))
            v_heads.append(batched_bilinear_sample(
                value[..., sl], obj_img_ind, feat_xy[:, h], 'border'))
        k_samples = torch.stack(k_heads, 1).transpose(2, 3)
        v_samples = torch.stack(v_heads, 1).transpose(2, 3)
        x2d_samples = batched_bilinear_sample(
            img_dense_x2d, obj_img_ind, feat_xy, 'border').transpose(2, 3)
        mask_samples = batched_bilinear_sample(
            img_dense_x2d_mask, obj_img_ind, feat_xy, 'zeros').transpose(2, 3)

        a_samples = query @ k_samples / math.sqrt(head_dim)
        a_soft = torch.softmax(a_samples, -1) * mask_samples
        out = (v_samples @ a_soft.transpose(-1, -2)).reshape(num_obj,
                                                              self.embed_dims)
        out = self.layer_norms[0](self.out_proj(out) + obj_emb)
        out = self.layer_norms[1](out + self.ffn.layers(out))
        return SamplerOutputs(out, v_samples, a_samples, mask_samples,
                              x2d_samples)
