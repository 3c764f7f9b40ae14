"""Per-point transformer layer (PyTorch), counterpart of
``epropnp_tpu/models/dense_heads/pts_transformer.py``.

mmcv ``BaseTransformerLayer`` order: self-attention (positional encoding
added to query and key) -> norm -> FFN -> norm. Parameters keep mmcv's
names: ``attentions.0.attn.in_proj_weight``/``in_proj_bias`` hold the q,
k and v projections packed as rows [q; k; v] (``nn.MultiheadAttention``),
then ``attentions.0.attn.out_proj``, ``norms.{0,1}`` and
``ffns.0.layers.{0.0,1}``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.deformable_attention import ffn


class _PackedAttention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` under its names."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims,
                                                       embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)
        nn.init.xavier_uniform_(self.in_proj_weight)


class PtsTransformerLayer(nn.Module):
    def __init__(self, embed_dims: int = 32, num_heads: int = 1,
                 ffn_dims: int = 256):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        attn = nn.Module()
        attn.attn = _PackedAttention(embed_dims)
        self.attentions = nn.ModuleList([attn])
        self.norms = nn.ModuleList(
            [nn.LayerNorm(embed_dims, eps=1e-5) for _ in range(2)])
        self.ffns = nn.ModuleList([ffn(embed_dims, ffn_dims)])

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x, pos: (num_obj, num_pts, embed)."""
        attn = self.attentions[0].attn
        e, nh = self.embed_dims, self.num_heads
        d = e // nh
        w, b = attn.in_proj_weight, attn.in_proj_bias
        q = torch.nn.functional.linear(x + pos, w[:e], b[:e])
        k = torch.nn.functional.linear(x + pos, w[e:2 * e], b[e:2 * e])
        v = torch.nn.functional.linear(x, w[2 * e:], b[2 * e:])

        def split(t):
            n, p, _ = t.shape
            return t.reshape(n, p, nh, d).transpose(1, 2)

        a = torch.softmax(split(q) @ split(k).transpose(-1, -2)
                          / math.sqrt(d), -1)
        out = (a @ split(v)).transpose(1, 2).reshape(x.shape)
        x = self.norms[0](x + attn.out_proj(out))
        return self.norms[1](x + self.ffns[0].layers(x))
