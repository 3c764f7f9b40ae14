"""The port's deformable convolution (K3's twin) against the JAX package.

The same numpy inputs (``np.random.default_rng``) go through the flax
``DeformConv`` (the jnp path, and the Pallas contraction in interpret
mode, with the float or the int8 table) and through the port's
``DeformConv``, whose weights come from the flax variables by the
``det_state_dict`` rules (mmcv layout, offset pairs swapped). float32 on
both sides; the tolerances are the JAX DCN tests' forward ones, rtol 1e-4
/ atol 1e-5 (``tests/test_pallas_dcn.py``), or 1e-4 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epropnp_tpu.ops.pallas_dcn as pallas_dcn
from epropnp_tpu.ops import level_pack as jlevel_pack
from epropnp_tpu.ops.bilinear_sample import pack_patches
from epropnp_tpu.models.backbones.resnet import Bottleneck as FlaxBottleneck
from epropnp_tpu.ops.deform_conv import DeformConv as FlaxDeformConv
from epropnp_tpu_torch.models.backbones.resnet import Bottleneck
from epropnp_tpu_torch.ops import dcn_kernel, level_pack
from epropnp_tpu_torch.ops.deform_conv import DeformConv
from epropnp_tpu_torch.utils import convert

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5


def _randomize(variables, seed, scale=0.2):
    """Seeded normal leaves (f32): offsets of a few pixels, some reaching
    outside the map. BatchNorm variances stay positive."""
    r = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == 'var':
            return r.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return r.normal(scale=scale, size=x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _port_deform_conv(p, c_in, c_out, stride, bias=True, int8_gather=False):
    """A port DeformConv holding the flax DeformConv params ``p``."""
    sd = {}
    convert._deform_conv(sd, 'm', p, bias=bias)
    mod = DeformConv(c_in, c_out, stride, bias=bias, int8_gather=int8_gather)
    mod.load_state_dict({k[2:]: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=True)
    return mod


@pytest.mark.parametrize('stride,h,w,c,cout', [
    (1, 10, 14, 32, 24), (2, 10, 14, 32, 24), (1, 5, 13, 8, 8),
    (2, 7, 9, 16, 12)])
def test_deform_conv_matches_flax(stride, h, w, c, cout):
    x = np.random.default_rng(h * w + stride).normal(
        size=(2, h, w, c)).astype(np.float32)
    m = FlaxDeformConv(cout, strides=stride, fused=False)
    vs = _randomize(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), stride)
    ref = np.asarray(m.apply(vs, jnp.asarray(x)))
    mod = _port_deform_conv(vs['params'], c, cout, stride)
    before = dcn_kernel.launches
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert dcn_kernel.launches == before  # the twin runs on the CPU
    # the offsets reach outside the map (zero-padded corners exercised)
    om = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), vs['params']['conv_offset']['kernel'],
        (stride, stride), ((1, 1), (1, 1)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC')))
    assert np.abs(om[..., :18]).max() > 2.0
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('stride', [1, 2])
def test_deform_conv_matches_pallas_contraction(stride, monkeypatch):
    """Against the fused path: the Pallas ``_contract_pallas`` kernel that
    K3 replaces, in interpret mode."""
    monkeypatch.setattr(pallas_dcn, 'INTERPRET', True)
    x = np.random.default_rng(7).normal(size=(1, 5, 13, 16)).astype(
        np.float32)  # h * w = 65: a ragged L block
    m = FlaxDeformConv(8, strides=stride, fused=True)
    vs = _randomize(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    ref = np.asarray(m.apply(vs, jnp.asarray(x)))
    mod = _port_deform_conv(vs['params'], 16, 8, stride)
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_dcn_bottleneck_stride2_matches_flax():
    """The strided first block of a DCN stage (eval-mode BatchNorm)."""
    x = np.random.default_rng(11).normal(size=(2, 9, 11, 32)).astype(
        np.float32)
    m = FlaxBottleneck(16, strides=2, use_dcn=True)
    vs = m.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    vs = _randomize(vs, 12, scale=0.1)
    p = vs['params']
    p['DeformConv_0']['bias'] = np.zeros_like(p['DeformConv_0']['bias'])
    ref = np.asarray(m.apply(vs, jnp.asarray(x), train=False))

    sd = {}
    convert._deform_conv(sd, 'conv2', p['DeformConv_0'], bias=False)
    for j, name in ((1, 'Conv_0'), (3, 'Conv_1')):
        sd[f'conv{j}.weight'] = convert.conv_weight(p[name]['kernel'])
    for j in range(3):
        convert._bn(sd, f'bn{j + 1}', p[f'BatchNorm_{j}'],
                    vs['batch_stats'][f'BatchNorm_{j}'])
    sd['downsample.0.weight'] = convert.conv_weight(
        p['downsample_conv']['kernel'])
    convert._bn(sd, 'downsample.1', p['BatchNorm_3'],
                vs['batch_stats']['BatchNorm_3'])
    block = Bottleneck(32, 16, stride=2, use_dcn=True).eval()
    block.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 5, 6, 64)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_dcn_wrapper_refuses_what_it_does_not_run():
    """The wrapper refuses other devices, and a gradient through the int8
    map (forward only, as JAX's ``dcn_gather_contract_q``); the f32 and
    bf16 maps, with or without a level table, take one."""
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.normal(size=(1, 6, 6, 16)).astype(np.float32))
    om = torch.zeros(1, 6, 6, 27)
    weight = torch.from_numpy(r.normal(size=(16, 16, 3, 3)).astype(
        np.float32))
    with pytest.raises(ValueError, match='CUDA tensors'):
        dcn_kernel.dcn_forward_cuda(x, om, dcn_kernel.kernel_weight(weight))
    with pytest.raises(ValueError, match='unsupported device'):
        with torch.no_grad():
            dcn_kernel.dcn_forward(x.to('meta'), om.to('meta'),
                                   weight.to('meta'))
    w_grad = weight.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match='forward only'):
        q, w_scaled = dcn_kernel.quantize_nhwc(
            x, dcn_kernel.kernel_weight(w_grad))
        dcn_kernel.dcn_forward(q, om, w_scaled)
    with pytest.raises(NotImplementedError, match='forward only'):
        q, w_scaled = dcn_kernel.quantize_nhwc(
            x, dcn_kernel.kernel_weight(w_grad).bfloat16())
        dcn_kernel.dcn_forward(q, om, w_scaled, levels=[(0, 0, 6, 6)])
    for out in (dcn_kernel.dcn_forward(x, om, w_grad),
                dcn_kernel.dcn_forward(x.bfloat16(), om, w_grad),
                dcn_kernel.dcn_forward(x, om, w_grad, levels=[(0, 0, 6, 6)])):
        assert out.grad_fn is not None
    with torch.no_grad():  # the twin: zero offsets, mask 0 -> mod = 1
        out = dcn_kernel.dcn_forward(x, om, weight, modulation_scale=2.0)
    plain = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), weight,
                                       padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), plain.detach().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('w_dtype', [np.float32, jnp.bfloat16])
def test_quantize_nhwc_matches_quantize_packed_table(w_dtype):
    """``quantize_nhwc`` on a map against ``quantize_packed_table`` on the
    map's patch table (every image, zero pad rows included): the same
    int8 codes (a code may differ by 1 where x / scale * 127 falls on an
    exact .5, which the two frameworks may round from either side: at most
    one in 10^4 codes) and the same scaled weight, bit for bit."""
    r = np.random.default_rng(21)
    x = r.normal(size=(2, 9, 13, 32)).astype(np.float32)
    x[1, 2, 3] *= 4.0  # a distinct channel maximum in one image
    kern = (r.normal(size=(9, 32, 24)) * 0.1).astype(np.float32)
    table = jax.vmap(pack_patches)(jnp.asarray(x)).reshape(-1, 4 * 32)
    q_ref, k_ref = pallas_dcn.quantize_packed_table(
        table, jnp.asarray(kern, w_dtype))
    # the last corner block of patch row (yi, xi) is x[yi, xi]
    q_ref = np.asarray(q_ref).reshape(2, 11, 15, 4, 32)[:, :9, :13, 3]
    q, k = dcn_kernel.quantize_nhwc(
        torch.from_numpy(x),
        torch.from_numpy(kern).to(torch.bfloat16 if w_dtype is jnp.bfloat16
                                  else torch.float32))
    assert q.dtype == torch.int8
    diff = np.abs(q.numpy().astype(np.int32) - q_ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    np.testing.assert_array_equal(k.float().numpy(),
                                  np.asarray(k_ref, np.float32))


@pytest.mark.parametrize('stride', [1, 2, 'packed'])
def test_int8_twin_matches_pallas_int8(stride, monkeypatch):
    """The int8 path (``quantize_nhwc`` + K3's twin) against the flax
    ``DeformConv(fused=True, int8_gather=True)`` (``quantize_packed_table``
    and the Pallas contraction in interpret mode), per level at stride 1
    and 2, and level-packed: f32 kernel, 1e-4 of the largest entry."""
    monkeypatch.setattr(pallas_dcn, 'INTERPRET', True)
    r = np.random.default_rng(31)
    if stride == 'packed':
        shapes = [(9, 14), (5, 7), (3, 4)]
        feats = [r.normal(size=(2, h, w, 16)).astype(np.float32)
                 for h, w in shapes]
        jlay = jlevel_pack.plan_level_packing(shapes)
        x = np.array(jlevel_pack.pack_levels(
            [jnp.asarray(f) for f in feats], jlay))
        layout = level_pack.plan_level_packing(shapes)
    else:
        x = r.normal(size=(2, 9, 13, 16)).astype(np.float32)
        jlay = layout = None
    m = FlaxDeformConv(8, strides=1 if stride == 'packed' else stride,
                       fused=True, int8_gather=True)
    vs = _randomize(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    ref = np.asarray(m.apply(vs, jnp.asarray(x), layout=jlay))
    mod = _port_deform_conv(vs['params'], 16, 8,
                            1 if stride == 'packed' else stride,
                            int8_gather=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x), layout=layout).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    if stride == 'packed':  # zeros in the gaps, as the JAX canvas
        gaps = layout.mask().numpy()[..., 0] == 0
        assert (out[:, gaps] == 0).all()


def _dcn_grad_problem(stride, seed=0, n=2, h=7, w=9, c=8, cout=6):
    """f64 inputs whose offsets reach past the map (a tenth of the corner
    samples fall off it)."""
    r = np.random.default_rng(seed)
    ho, wo = dcn_kernel.output_hw(h, w, stride)
    x = torch.from_numpy(r.normal(size=(n, h, w, c)))
    om = torch.from_numpy(r.normal(size=(n, ho, wo, 27)) * 2.0)
    weight = torch.from_numpy(r.normal(size=(cout, c, 3, 3)))
    bias = torch.from_numpy(r.normal(size=(cout,)))
    ct = torch.from_numpy(r.normal(size=(n, ho, wo, cout)))
    _, w4 = dcn_kernel.corner_rows_and_weights(om, (0, 0, h, w), (h, w),
                                               stride, 2.0)
    assert 0.02 < float((w4 == 0).double().mean()) < 0.5
    return x, om, weight, bias, ct


@pytest.mark.parametrize('chunk_rows', [7, dcn_kernel.BWD_CHUNK_ROWS])
@pytest.mark.parametrize('stride', [1, 2])
def test_dcn_backward_matches_autograd_of_the_twin(stride, chunk_rows):
    """``dcn_backward``, streamed in chunks of 7 output rows or whole,
    against torch autograd through ``dcn_reference`` (f64, 1e-12 of the
    largest entry)."""
    x, om, weight, bias, ct = _dcn_grad_problem(stride, seed=stride)
    leaves = [t.clone().requires_grad_() for t in (x, om, weight, bias)]
    out = dcn_kernel.dcn_reference(*leaves, stride=stride)
    ref = torch.autograd.grad(out, leaves, ct)
    got = dcn_kernel.dcn_backward(x, om, dcn_kernel.kernel_weight(weight),
                                  ct, stride, 2.0, chunk_rows=chunk_rows)
    got = (got[0], got[1], got[2].reshape(3, 3, 8, 6).permute(3, 2, 0, 1),
           got[3])
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-12 * float(r.abs().max())


@pytest.mark.parametrize('chunk_rows', [5, dcn_kernel.BWD_CHUNK_ROWS])
@pytest.mark.parametrize('stride', [1, 2])
def test_deform_conv_gradients_match_jax(stride, chunk_rows, monkeypatch):
    """Gradients through the port's ``DeformConv`` (``DCNFunction``: the
    twin's forward, ``dcn_backward``) against ``jax.grad`` of the flax
    ``DeformConv`` (jnp path), f64, for the input, the kernel, the bias and
    the offset conv: rtol 1e-9 of each tensor's largest entry. Offsets of a
    few pixels put samples off the map."""
    monkeypatch.setattr(dcn_kernel, 'BWD_CHUNK_ROWS', chunk_rows)
    r = np.random.default_rng(40 + stride)
    x = r.normal(size=(2, 7, 9, 8))
    m = FlaxDeformConv(6, strides=stride, fused=False, dtype=jnp.float64)
    vs = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                _randomize(m.init(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)), 5,
                                           scale=0.3))
    ct = r.normal(size=m.apply(vs, jnp.asarray(x)).shape)

    def loss(params, xx):
        return jnp.sum(m.apply({'params': params}, xx) * ct)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(vs['params'],
                                                   jnp.asarray(x))
    mod = _port_deform_conv(vs['params'], 8, 6, stride).double()
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt)
    (out * torch.from_numpy(ct)).sum().backward()
    sd = {}
    convert._deform_conv(sd, 'm', jax.tree_util.tree_map(np.asarray,
                                                         g_params),
                         bias=True)
    pairs = [(xt.grad, np.asarray(g_x))] + [
        (p.grad, sd['m.' + name]) for name, p in mod.named_parameters()]
    assert len(pairs) == 5
    for got, ref in pairs:
        assert got.shape == ref.shape
        assert float(np.abs(got.numpy() - ref).max()) \
            <= 1e-9 * float(np.abs(ref).max())
