"""The port's level packing and packed FCOS head against the JAX package.

The planner is a copy, so both packages must place the levels alike. The
packed FCOS head must give the per-level head's outputs (the same modules,
GroupNorm per level, no sampling across level borders) and the JAX
package's packed head's, on the same numpy inputs, in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epropnp_tpu.models.dense_heads.fcos_emb_head import (
    FCOSEmbHead as FlaxFCOSEmbHead)
from epropnp_tpu.ops import level_pack as jlevel_pack
from epropnp_tpu_torch.models.dense_heads.fcos_emb_head import FCOSEmbHead
from epropnp_tpu_torch.ops import level_pack
from epropnp_tpu_torch.utils import convert

torch.set_num_threads(1)
SHAPES = ((16, 40), (8, 20), (4, 10), (2, 5))
HEAD_KW = dict(num_classes=4, in_channels=32, feat_channels=32,
               emb_channels=16, strides=(8, 16, 32, 64), cls_branch=(32,),
               centerness_branch=(16,), offset_branch=(32,),
               emb_branch=(32,))


def _pyramid(seed, c=32, n=2):
    r = np.random.default_rng(seed)
    return [r.normal(size=(n, h, w, c)).astype(np.float32)
            for h, w in SHAPES]


def _close_to_max(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * np.abs(b).max() + 1e-30


@pytest.mark.parametrize('shapes', [
    [(84, 200), (42, 100), (21, 50), (11, 25), (6, 13)],   # 672x1600
    [(8, 8), (4, 4), (2, 2), (1, 1)]])                      # 64x64
def test_plan_matches_jax(shapes):
    got = level_pack.plan_level_packing(shapes)
    ref = jlevel_pack.plan_level_packing(shapes)
    assert got.origins == ref.origins
    assert got.canvas_hw == ref.canvas_hw
    assert got.waste() == ref.waste()
    if shapes[0] == (84, 200):
        assert got.canvas_hw == (128, 200)
    np.testing.assert_array_equal(got.mask().numpy(), np.asarray(ref.mask))
    feats = [torch.randn(1, h, w, 3) for h, w in shapes]
    comp = level_pack.pack_levels(feats, got)
    back = level_pack.unpack_levels(comp, got)
    assert all(torch.equal(a, b) for a, b in zip(feats, back))
    noisy = comp + (1 - got.mask()) * 5.0  # what a conv leaves in the gaps
    assert torch.equal(level_pack.rezero_gaps(noisy, got), comp)


def _port_head(level_packed, offset_cls_agnostic=True, seed=0):
    torch.manual_seed(seed)
    head = FCOSEmbHead(level_packed=level_packed,
                       offset_cls_agnostic=offset_cls_agnostic, **HEAD_KW)
    with torch.no_grad():  # offsets of a pixel or so, GN affine non-trivial
        for name, p in head.named_parameters():
            if 'conv_offset' in name or '.gn.' in name:
                p.normal_(0, 0.2)
    return head.eval()


def test_packed_head_equals_per_level_head():
    """The same port head run per level and packed: f32, 1e-5 of each
    output's largest entry (sums in another order only)."""
    ref_head = _port_head(False)
    pk_head = _port_head(True)
    pk_head.load_state_dict(ref_head.state_dict())
    feats = [torch.from_numpy(f) for f in _pyramid(3)]
    with torch.no_grad():
        ref = ref_head(feats)
        got = pk_head(feats)
    for lo_r, lo_g in zip(ref, got):
        for name in lo_r._fields:
            _close_to_max(getattr(lo_g, name), getattr(lo_r, name), 1e-5)


@pytest.mark.parametrize('offset_cls_agnostic', [True, False])
def test_packed_head_matches_flax_packed_head(offset_cls_agnostic):
    """Against ``FCOSEmbHead(level_packed=True)`` of the JAX package (the
    jnp DCN path), same weights (``det_state_dict``'s head rules): f32,
    1e-4 of each output's largest entry."""
    feats = _pyramid(5)
    kw = dict(HEAD_KW, regress_ranges=((-1, 48), (48, 96), (96, 192),
                                       (192, 1e8)),
              offset_cls_agnostic=offset_cls_agnostic)
    jhead = FlaxFCOSEmbHead(level_packed=True, **kw)
    var = jhead.init(jax.random.PRNGKey(0), tuple(map(jnp.asarray, feats)))
    r = np.random.default_rng(2)

    def leaf(path, p):
        keys = [str(getattr(k, 'key', '')) for k in path]
        if '_dcn' in keys[-2] and keys[-1] == 'bias':
            return np.zeros(p.shape, np.float32)  # mmcv's DCN has no bias
        return r.normal(scale=0.1, size=p.shape).astype(np.float32)
    var = jax.tree_util.tree_map_with_path(leaf, var)
    ref = jhead.apply(var, tuple(map(jnp.asarray, feats)))

    sd = {}
    convert._fcos_head(sd, var['params'], '')
    head = FCOSEmbHead(level_packed=True,
                       offset_cls_agnostic=offset_cls_agnostic, **HEAD_KW)
    head.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = head.eval()([torch.from_numpy(f) for f in feats])
    for lo_r, lo_g in zip(ref, got):
        for name in lo_r._fields:
            _close_to_max(getattr(lo_g, name).numpy(), getattr(lo_r, name),
                          1e-4)
