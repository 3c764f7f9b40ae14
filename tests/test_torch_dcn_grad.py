"""K3's gradient with a bf16 map and with a level table, against the JAX
package's ``custom_vjp`` and an f64 reference.

The JAX side is ``pallas_dcn.dcn_gather_contract`` (the Pallas contraction
in interpret mode) with ``BWD_CHUNK_ROWS`` patched small, so that its
backward is ``_bwd_chunked``: the corners re-gathered chunk by chunk, all
of it in f32, ``d_packed`` accumulated in the table's dtype. Its rows and
corner weights come from ``bilinear_sample.corner_rows_and_weights`` on
positions computed in f32 from the same offsets as the port's (the flax
``DeformConv`` builds them in its own dtype, bf16 under ``bf16_dense``: a
known difference, ``ROADMAP.md``), and the map reaches the table through
``pack_patches``, so ``jax.grad`` returns the gradients of the map, the
raw offset/mask conv output and the kernel, as the port's ``DCNFunction``
(``dcn_backward``, chunked the same way) does.

Both packages are held to an f64 reference, autograd of the port's twin
(``dcn_reference``) in f64 on the same bf16-rounded inputs: the port
accumulates the map's gradient in f32 and rounds once, JAX in bf16 chunk
by chunk. Then the packed ``DeformConv`` and the packed FCOS towers under
autograd: the port's against the flax ``DeformConv``'s (f64), and packed
against per level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epropnp_tpu.ops.pallas_dcn as pallas_dcn
from epropnp_tpu.ops import level_pack as jlevel_pack
from epropnp_tpu.ops.bilinear_sample import (corner_rows_and_weights,
                                             pack_patches)
from epropnp_tpu.ops.deform_conv import DeformConv as FlaxDeformConv
from epropnp_tpu_torch.models.dense_heads.fcos_emb_head import FCOSEmbHead
from epropnp_tpu_torch.ops import dcn_kernel, level_pack
from epropnp_tpu_torch.ops.deform_conv import DeformConv
from epropnp_tpu_torch.utils import convert

torch.set_num_threads(1)
CHUNK = 16  # rows a chunk in both backwards: several chunks a level
SHAPES = [(9, 14), (5, 7), (3, 4)]
# a bf16 gradient rounded once from f32: within 2^-8 of the largest entry
BF16_ONE_ROUNDING = 2.0 ** -8


def _problem(seed, levels, stride=1, n=2, c=32, cout=8, h=9, w=13):
    """f64 inputs: a map (a canvas of SHAPES with zero gaps for
    ``levels``), offsets of a few pixels (some corners off the map or
    their level), the kernel (9, c, cout) and a cotangent."""
    r = np.random.default_rng(seed)
    if levels:
        layout = level_pack.plan_level_packing(SHAPES)
        x = level_pack.pack_levels(
            [torch.from_numpy(r.normal(size=(n, lh, lw, c)))
             for lh, lw in SHAPES], layout).numpy()
        regions = layout.regions()
        om = r.normal(size=x.shape[:3] + (27,)) * 1.5
        length = n * sum(lh * lw for lh, lw in SHAPES)
        ct = r.normal(size=(length, cout))
    else:
        x = r.normal(size=(n, h, w, c))
        regions = None
        ho, wo = dcn_kernel.output_hw(h, w, stride)
        om = r.normal(size=(n, ho, wo, 27)) * 1.5
        ct = r.normal(size=(n, ho, wo, cout))
    kern = r.normal(size=(9, c, cout)) * 0.2
    return x, om, kern, ct, regions


def _jax_dcn(x, om, kern, stride, regions):
    """The port's DCN through the JAX package's ``dcn_gather_contract``:
    per level a ``pack_patches`` table, positions in f32 (f64 for f64
    offsets) from the port's (dy, dx) offset layout, the modulation folded
    into the corner weights, one contraction of all levels."""
    n, hc, wc, c = x.shape
    pdt = jnp.float64 if om.dtype == jnp.float64 else jnp.float32
    om = om.astype(pdt)
    parts = ([((0, 0, hc, wc), stride)] if regions is None
             else [(r, 1) for r in regions])
    tables, rows, w4s, base = [], [], [], 0
    for (y0, x0, h, w), s in parts:
        if regions is None:
            o = om
        else:
            o = om[:, y0:y0 + h, x0:x0 + w]
        ho, wo = o.shape[1:3]
        packed = jax.vmap(pack_patches)(x[:, y0:y0 + h, x0:x0 + w])
        rpi = packed.shape[1] * packed.shape[2]
        off = o[..., :18].reshape(n, ho, wo, 9, 2)
        tap = jnp.arange(9)
        cy = (jnp.arange(ho, dtype=pdt) * s)[None, :, None, None] \
            + (tap // 3 - 1).astype(pdt) + off[..., 0]
        cx = (jnp.arange(wo, dtype=pdt) * s)[None, None, :, None] \
            + (tap % 3 - 1).astype(pdt) + off[..., 1]
        r, w4 = corner_rows_and_weights(jnp.stack([cx, cy], -1), (h, w),
                                        'zeros')
        w4 = w4 * (jax.nn.sigmoid(o[..., 18:]) * 2.0)[..., None]
        r = r + base + (jnp.arange(n) * rpi)[:, None, None, None]
        tables.append(packed.reshape(-1, 4 * c))
        rows.append(r.reshape(-1, 9).T)
        w4s.append(w4.reshape(-1, 9, 4).swapaxes(0, 1))
        base += n * rpi
    out = pallas_dcn.dcn_gather_contract(
        jnp.concatenate(tables), jnp.concatenate(rows, 1),
        jnp.concatenate(w4s, 1), kern)
    return out if regions is not None else out.reshape(
        (n,) + dcn_kernel.output_hw(hc, wc, stride) + (-1,))


def _jax_grads(x, om, kern, ct, stride, regions):
    def loss(x, om, kern):
        out = _jax_dcn(x, om, kern, stride, regions)
        return jnp.sum(out.astype(jnp.float64) * ct)
    return [np.asarray(g, np.float64) for g in jax.grad(
        loss, argnums=(0, 1, 2))(x, om, kern)]


def _port_grads(x, om, kern, ct, stride, regions, dtype):
    leaves = [torch.from_numpy(np.asarray(x, np.float64)).to(dtype),
              torch.from_numpy(np.asarray(om, np.float64)).to(dtype),
              torch.from_numpy(np.asarray(kern, np.float64)).to(
                  torch.float64 if dtype == torch.float64
                  else torch.float32)]
    leaves = [t.requires_grad_() for t in leaves]
    out = dcn_kernel.dcn_forward(*leaves, stride=stride, levels=regions)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct).to(
        out.dtype))
    return [g.double().numpy() for g in grads], [g.dtype for g in grads]


def _reference(x, om, kern, ct, stride, regions):
    """Autograd of the twin in f64 on the given (rounded) inputs."""
    leaves = [torch.from_numpy(np.asarray(a, np.float64)).requires_grad_()
              for a in (x, om, kern)]
    out = dcn_kernel.dcn_reference(*leaves, stride=stride, levels=regions)
    return [g.numpy() for g in torch.autograd.grad(
        out, leaves, torch.from_numpy(ct))]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _rel_l2(a, b):
    """Relative L2 distance of two dicts of gradients over all leaves."""
    keys = [k for k in b if b[k] is not None]
    return float(sum(float((a[k] - b[k]).square().sum()) for k in keys)
                 / sum(float(b[k].square().sum()) for k in keys)) ** 0.5


@pytest.fixture
def chunked(monkeypatch):
    monkeypatch.setattr(pallas_dcn, 'INTERPRET', True)
    monkeypatch.setattr(pallas_dcn, 'BWD_CHUNK_ROWS', CHUNK)
    monkeypatch.setattr(dcn_kernel, 'BWD_CHUNK_ROWS', CHUNK)


@pytest.mark.parametrize('case', ['stride1', 'stride2', 'levels'])
def test_bf16_gradient_matches_jax_custom_vjp(case, chunked):
    """A bf16 map and offsets, an f32 kernel (the training path: f32
    parameters): the port's gradients come back as the inputs' dtypes
    (bf16, bf16, f32) and lie within one bf16 rounding of the f64
    reference (2^-8 of the largest entry; the kernel's gradient, f32,
    within 1e-5); JAX's within 2^-8 too on the offsets and the kernel,
    and no nearer than the port's on the map (its ``d_packed`` sums in
    bf16). Port and JAX within 8e-3 of the largest entry (chip_smoke's
    bf16 gate)."""
    stride = 2 if case == 'stride2' else 1
    x, om, kern, ct, regions = _problem(5, case == 'levels', stride)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    omb = np.asarray(jnp.asarray(om, jnp.bfloat16))
    kf = kern.astype(np.float32)
    ctb = np.asarray(jnp.asarray(ct, jnp.bfloat16), np.float64)
    got, dtypes = _port_grads(xb.astype(np.float64), omb.astype(np.float64),
                              kf, ctb, stride, regions, torch.bfloat16)
    assert dtypes == [torch.bfloat16, torch.bfloat16, torch.float32]
    ref = _reference(xb, omb, kf, ctb, stride, regions)
    jgot = _jax_grads(jnp.asarray(xb), jnp.asarray(omb), jnp.asarray(kf),
                      ctb, stride, regions)
    for name, p, j, r in zip(('map', 'offsets', 'kernel'), got, jgot, ref):
        port_err, jax_err = _rel(p, r), _rel(j, r)
        limit = 1e-5 if name == 'kernel' else BF16_ONE_ROUNDING
        assert port_err <= limit, (name, port_err)
        if name == 'map':
            assert port_err <= max(jax_err, 1e-30) * 1.0 + 1e-12, \
                (name, port_err, jax_err)
        else:
            assert jax_err <= limit, (name, jax_err)
        assert _rel(p, j) <= 8e-3, (name, _rel(p, j))


@pytest.mark.parametrize('dtype', ['f32', 'f64'])
def test_level_table_gradient_matches_jax_custom_vjp(dtype, chunked):
    """The f32 (and f64) canvas with a level table: every position samples
    its own level's region (a corner outside it has weight 0 and passes
    nothing), the map's and the offsets' gradients are 0 in the gaps, and
    the port's gradients meet JAX's ``_bwd_chunked`` within JAX's chunked
    gradient rule (rtol 5e-4, ``tests/test_pallas_dcn.py``) of the largest
    entry (in f64 too: ``_bwd_chunked`` computes in f32 whatever the
    table's dtype, 7e-8 here), and the f64 reference within 1e-4 in f32,
    1e-12 in f64."""
    x, om, kern, ct, regions = _problem(7, True)
    np_dt = np.float32 if dtype == 'f32' else np.float64
    x, om, kern = x.astype(np_dt), om.astype(np_dt), kern.astype(np_dt)
    got, _ = _port_grads(x, om, kern, ct, 1, regions,
                         torch.float32 if dtype == 'f32' else torch.float64)
    ref = _reference(x, om, kern, ct, 1, regions)
    jgot = _jax_grads(jnp.asarray(x), jnp.asarray(om), jnp.asarray(kern),
                      ct, 1, regions)
    tol_ref = 1e-4 if dtype == 'f32' else 1e-12
    tol_jax = 5e-4
    for name, p, j, r in zip(('map', 'offsets', 'kernel'), got, jgot, ref):
        assert _rel(p, j) <= tol_jax, (name, _rel(p, j))
        assert _rel(p, r) <= tol_ref, (name, _rel(p, r))
    gaps = level_pack.plan_level_packing(SHAPES).mask().numpy()[..., 0] == 0
    assert (got[0][:, gaps] == 0).all() and (got[1][:, gaps] == 0).all()
    # offsets that push corners out of their level: their weight is 0
    _, w4 = dcn_kernel.corner_rows_and_weights(
        torch.from_numpy(np.asarray(om[:, :9, :14], np.float64)),
        regions[0], x.shape[1:3], 1, 2.0)
    assert 0.05 < float((w4 == 0).double().mean()) < 0.6


def _flax_packed_conv(feats, c, cout, seed):
    """f64 flax DeformConv on the jnp path, randomised parameters (offsets
    of a pixel or so); its canvas and layout."""
    jlay = jlevel_pack.plan_level_packing([f.shape[1:3] for f in feats])
    canvas = jlevel_pack.pack_levels([jnp.asarray(f) for f in feats], jlay)
    m = FlaxDeformConv(cout, fused=False, dtype=jnp.float64)
    vs = m.init(jax.random.PRNGKey(0), canvas, layout=jlay)
    r = np.random.default_rng(seed)
    vs = jax.tree_util.tree_map(
        lambda a: r.normal(scale=0.3, size=a.shape), vs)
    return m, vs, canvas, jlay


def _port_conv(params, c, cout):
    sd = {}
    convert._deform_conv(sd, 'm', jax.tree_util.tree_map(np.asarray,
                                                         params), bias=True)
    mod = DeformConv(c, cout, bias=True).double()
    mod.load_state_dict({k[2:]: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=True)
    return mod


def test_packed_deform_conv_gradients_match_flax():
    """``DeformConv(x, layout=...)`` under autograd (the offset conv on
    the canvas, K3 with the level table, each level's rows written into
    the output canvas) against ``jax.grad`` of the flax ``DeformConv`` on
    its packed canvas, f64: the canvas, the kernel, the bias and the
    offset conv within 1e-9 of each tensor's largest entry; the output's
    gaps are zero. (The canvas' gaps do get a gradient, through the offset
    conv's zero padding, in both packages; ``pack_levels`` drops it.)"""
    r = np.random.default_rng(3)
    feats = [r.normal(size=(2, h, w, 16)) for h, w in SHAPES]
    m, vs, canvas, jlay = _flax_packed_conv(feats, 16, 8, 4)
    ct = r.normal(size=m.apply(vs, canvas, layout=jlay).shape)

    def loss(params, xx):
        return jnp.sum(m.apply({'params': params}, xx, layout=jlay) * ct)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(vs['params'], canvas)
    mod = _port_conv(vs['params'], 16, 8)
    layout = level_pack.plan_level_packing(SHAPES)
    xt = torch.from_numpy(np.array(canvas)).requires_grad_()
    out = mod(xt, layout=layout)
    (out * torch.from_numpy(ct)).sum().backward()
    sd = {}
    convert._deform_conv(sd, 'm', jax.tree_util.tree_map(np.asarray,
                                                         g_params), bias=True)
    pairs = [(xt.grad, np.asarray(g_x))] + [
        (p.grad, sd['m.' + name]) for name, p in mod.named_parameters()]
    assert len(pairs) == 5
    for got, ref in pairs:
        assert got.shape == ref.shape
        assert float(np.abs(got.numpy() - ref).max()) \
            <= 1e-9 * float(np.abs(ref).max())
    gaps = layout.mask().numpy()[..., 0] == 0
    assert (out.detach().numpy()[:, gaps] == 0).all()


def test_level_pack_carries_gradients():
    """``pack_levels`` / ``unpack_levels`` / ``map_levels`` /
    ``rezero_gaps`` under autograd: each level's gradient is its region of
    the canvas' cotangent, and the zero gaps pass nothing."""
    r = np.random.default_rng(9)
    layout = level_pack.plan_level_packing(SHAPES)
    feats = [torch.from_numpy(r.normal(size=(2, h, w, 4))).requires_grad_()
             for h, w in SHAPES]
    canvas = level_pack.rezero_gaps(level_pack.map_levels(
        level_pack.pack_levels(feats, layout), layout, lambda t: t * 3.0),
        layout)
    ct = torch.from_numpy(r.normal(size=tuple(canvas.shape)))
    grads = torch.autograd.grad(canvas, feats, ct, retain_graph=True)
    for g, (y, x, h, w) in zip(grads, layout.regions()):
        assert torch.equal(g, 3.0 * ct[:, y:y + h, x:x + w])
    back = level_pack.unpack_levels(canvas, layout)
    g2 = torch.autograd.grad(sum(b.sum() for b in back), feats)
    assert all(torch.equal(g, torch.full_like(g, 3.0)) for g in g2)


@pytest.mark.parametrize('dense', ['f64', 'bf16'])
def test_fcos_towers_packed_gradients_equal_per_level(dense):
    """The FCOS head with ``level_packed`` against the per-level head, the
    same weights, under autograd (``tests/test_level_pack.py``'s gradient
    parity): f64, every parameter's gradient within 1e-9 of its largest
    entry; with ``dense_dtype`` bf16 (K3-bf16 with its level table) the
    packed and per-level runs round alike, within 2e-2 of the largest
    entry, and the packed gradients lie within 0.15
    (``tests/test_mixed_precision.py``'s rule, as a relative L2 distance
    over all parameters: per leaf, the GroupNorm scales' sums of bf16
    products lie up to 0.24 of their largest entry from f64) of the f64
    head's, no further than the per-level run's (x1.05)."""
    torch.manual_seed(0)
    kw = dict(num_classes=3, in_channels=32, feat_channels=32,
              strides=(8, 16, 32), emb_channels=32, cls_branch=(32,),
              centerness_branch=(16,), offset_branch=(32,),
              emb_branch=(32,))
    ddt = torch.bfloat16 if dense == 'bf16' else None
    heads = {'flat': FCOSEmbHead(**kw, dense_dtype=ddt).double(),
             'packed': FCOSEmbHead(**kw, dense_dtype=ddt,
                                   level_packed=True).double(),
             'f64': FCOSEmbHead(**kw).double()}
    with torch.no_grad():
        for mod in heads['flat'].modules():
            if isinstance(mod, DeformConv):
                mod.conv_offset.weight.normal_(0, 0.05)
    for name in ('packed', 'f64'):
        heads[name].load_state_dict(heads['flat'].state_dict())
    r = np.random.default_rng(2)
    feats = [torch.from_numpy(r.normal(size=(2, h, w, 32)))
             for h, w in ((8, 16), (4, 8), (2, 4))]
    cts = None
    grads = {}
    for name, head in heads.items():
        outs = head(feats)
        flat = [t for o in outs for t in o[:4]]
        if cts is None:
            cts = [torch.from_numpy(r.normal(size=tuple(t.shape)))
                   for t in flat]
        loss = sum((t * c).sum() for t, c in zip(flat, cts))
        params = dict(head.named_parameters())
        grads[name] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
    for k, ref in grads['f64'].items():
        if ref is None:
            continue
        scale = float(ref.abs().max())
        d = float((grads['packed'][k] - grads['flat'][k]).abs().max())
        assert d <= (1e-9 if dense == 'f64' else 2e-2) * scale, (k, d)
    if dense == 'bf16':  # 0.1265 for both here
        dist = {name: _rel_l2(grads[name], grads['f64'])
                for name in ('packed', 'flat')}
        assert dist['packed'] <= 0.15, dist
        assert dist['packed'] <= 1.05 * dist['flat'], dist


def test_bench_dcn_backward_loads_a_tree(monkeypatch):
    """``tools/bench_dcn_backward.py`` loads a source tree's
    ``dcn_kernel`` as a module of its own: on this tree, its
    ``dcn_backward`` gives the package's gradients bit for bit on a small
    problem of the tool's own making (stride 1 and 2); without a card the
    tool prints nothing and exits 1."""
    import os
    from epropnp_tpu_torch.tools import bench_dcn_backward as bench
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mod = bench.load_dcn_kernel(tree, 'this')
    assert mod is not dcn_kernel and mod.__name__ == '_dcn_kernel_this'
    for stride in (1, 2):
        x, om, w3, go, s = bench.problem((2, 7, 9, 8, 4, stride), 'cpu')
        assert om.shape[:3] == go.shape[:3] == (2, *dcn_kernel.output_hw(
            7, 9, stride))
        for a, b in zip(mod.dcn_backward(x, om, w3, go, s, chunk_rows=16),
                        dcn_kernel.dcn_backward(x, om, w3, go, s,
                                                chunk_rows=16)):
            assert torch.equal(a, b)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert bench.main(['--tree', f'this={tree}']) == 1
