"""K3: the DCNv2 sampling contraction, its plain twin, and the int8 table.

``dcn_forward`` is what ``DeformConv`` calls. On a CUDA tensor it launches
the hand-written kernel of ``csrc/dcn_kernel.cu`` (an implicit GEMM that
gathers the 4 bilinear corners of every tap from the NHWC map itself: f32
FMA on the CUDA cores for an f32 weight, bf16 products on the tensor cores
for a bf16 weight) or raises; on a CPU tensor it runs
:func:`dcn_reference`, the same function written with torch gathers and
one product with the weight.

For every output position (img, i, j) and output channel o::

    out = bias[o] + sum_tap sum_ci round_k(s_tap[ci]) * W[tap, ci, o]
    s_tap = sum_corner bilinear_zeros(x[img], p_tap) * mod_tap    (in f32)
    p_tap = (j s + dx_tap + off_x, i s + dy_tap + off_y)       in [x, y]
    mod_tap = sigmoid(mask_tap) * modulation_scale

with (dx_tap, dy_tap) in {-1, 0, 1}^2 row-major by (dy, dx). Layouts are
mmcv's: ``offset_mask`` is the raw ``conv_offset`` output, (n, ho, wo, 27)
NHWC with (dy, dx) for each tap then the 9 mask logits; the weight is
(cout, c, 3, 3), or (9, c, cout) in the kernel's layout. A corner outside
the map contributes 0. Positions and corner weights are computed in f32
from the offsets, whatever the map's dtype.

Variants, as the TPU kernel's (``pallas_dcn.py:50-65``): the map is f32,
bf16, or int8 from :func:`quantize_nhwc` (the per-channel scales folded
into the weight). The kernel dtype is the weight's for an int8 map and the
map's otherwise; the combined corner value is rounded to it (``round_k``),
the products accumulate in f32, and bias and output are in that dtype.

``levels`` turns the map into a canvas of pyramid levels (the packed FCOS
towers, stride 1): a list of (y0, x0, h, w) regions; each level samples
only its own region, and the output is (L, cout) with positions level by
level, then image, then row-major.

Gradients: the f32 or bf16 map (f64 too on the CPU), with or without a
level table, goes through :class:`DCNFunction`, whose forward is the
kernel (or the twin on the CPU) and whose backward is
:func:`dcn_backward`, plain torch ops in f32 streamed over chunks of
output rows (the counterpart of ``_bwd_chunked``,
``pallas_dcn.py:199-248``; the JAX package's backward is jnp too). The
int8 map is forward only, as the JAX int8 entry
(``dcn_gather_contract_q``): the wrapper refuses it inputs that require
grad while grad is enabled.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

TAPS = 9
MAX_LEVELS = 8
# Output rows per chunk of the backward (``BWD_CHUNK_ROWS`` of the JAX
# package): the (rows, 9, c) gathers of one corner stay ~75 MB at c=256 in
# f32, where the whole (taps, L, 4, c) stack at FCOS level 0 and 6 images
# would take 3.7 GB.
BWD_CHUNK_ROWS = 8192
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# Launches of the CUDA kernel, counted by :func:`dcn_forward_cuda` alone,
# one counter per map dtype: f32, bf16 and int8.
launches = 0
launches_bf16 = 0
launches_int8 = 0


def output_hw(h: int, w: int, stride: int):
    """Output size of a 3x3 conv with padding 1 (torch geometry)."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """mmcv weight (cout, c, 3, 3) -> the kernel's (9, c, cout) layout."""
    cout, c = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(TAPS, c, cout).contiguous()


def compute_dtype(x_dtype: torch.dtype, w_dtype: torch.dtype) -> torch.dtype:
    """The kernel dtype: the weight's for an int8 map, else the map's."""
    return w_dtype if x_dtype == torch.int8 else x_dtype


def quantize_nhwc(x: torch.Tensor, weight3: torch.Tensor,
                  eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel int8 quantization of an NHWC map, the counterpart of
    ``pallas_dcn.quantize_packed_table``.

    The channel scale is the amax over the whole map (every image and,
    on a canvas, every level; zero pad rows and zero gaps do not change
    it), at least ``eps``. Returns ``(q int8 (n, h, w, c), weight3 scaled
    by scale / 127 in weight3's dtype)``, so that ``q @ scaled ~= x @ w``.
    """
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=(0, 1, 2)), min=eps)
    q = torch.clamp(torch.round(xf / scale * 127.0), -127, 127).to(
        torch.int8)
    w_scaled = (weight3.float() * (scale / 127.0)[None, :, None]).to(
        weight3.dtype)
    return q, w_scaled


def corner_rows_and_weights(offset_mask, region, canvas_hw, stride,
                            modulation_scale):
    """Flat row indices into ``x.reshape(-1, c)`` and the 4 corner weights
    (validity and modulation folded in) of one level.

    ``region`` is the level's (y0, x0, h, w) on a canvas of ``canvas_hw``
    (the map itself for the per-level path); ``offset_mask`` is the
    level's (n, ho, wo, 27). Returns ``(rows, w4)``, each (n, ho, wo, 9,
    4): corners ordered [y0x0, y0x1, y1x0, y1x1]; an invalid corner has
    row 0 and weight 0. Computed in f32 (f64 for an f64 ``offset_mask``).
    """
    y_org, x_org, h, w = region
    hc, wc = canvas_hw
    n, ho, wo, _ = offset_mask.shape
    dt = torch.float64 if offset_mask.dtype == torch.float64 else \
        torch.float32
    om = offset_mask.to(dt)
    dev = om.device
    off = om[..., :2 * TAPS].reshape(n, ho, wo, TAPS, 2)
    mod = torch.sigmoid(om[..., 2 * TAPS:]) * modulation_scale
    tap = torch.arange(TAPS, device=dev)
    base_y = (tap // 3 - 1).to(dt)
    base_x = (tap % 3 - 1).to(dt)
    gy = (torch.arange(ho, device=dev, dtype=dt) * stride)[:, None, None]
    gx = (torch.arange(wo, device=dev, dtype=dt) * stride)[None, :, None]
    py = (gy + base_y) + off[..., 0]
    px = (gx + base_x) + off[..., 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    cw = [(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx]
    img = torch.arange(n, device=dev)[:, None, None, None]
    rows, weights = [], []
    for k in range(4):
        yy, xx = y0 + (k >> 1), x0 + (k & 1)
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yc = yy.clamp(0, h - 1).long() + y_org
        xc = xx.clamp(0, w - 1).long() + x_org
        rows.append(torch.where(inside, (img * hc + yc) * wc + xc, 0))
        weights.append(torch.where(inside, cw[k] * mod, 0))
    return torch.stack(rows, -1), torch.stack(weights, -1)


def sampled_stack(x, offset_mask, stride: int = 1,
                  modulation_scale: float = 2.0,
                  levels: Optional[Sequence[Tuple[int, int, int, int]]] = None,
                  acc: torch.dtype = torch.float32) -> torch.Tensor:
    """The combined corner values of every output position and tap, (L,
    9 c) in ``acc``: the A operand of K3's product, before ``round_k``.
    Arguments as :func:`dcn_reference`."""
    n, hc, wc, c = x.shape
    regions = levels if levels is not None else [(0, 0, hc, wc)]
    rows, w4 = [], []
    for y0, x0, h, w in regions:
        if levels is None:
            om = offset_mask
            s = stride
        else:
            om = offset_mask[:, y0:y0 + h, x0:x0 + w]
            s = 1
        r, wt = corner_rows_and_weights(om, (y0, x0, h, w), (hc, wc), s,
                                        modulation_scale)
        rows.append(r.reshape(-1, TAPS, 4))
        w4.append(wt.reshape(-1, TAPS, 4).to(acc))
    rows, w4 = torch.cat(rows), torch.cat(w4)
    flat = x.reshape(n * hc * wc, c).to(acc)
    sampled = sum(flat[rows[..., k]] * w4[..., k, None] for k in range(4))
    return sampled.reshape(-1, TAPS * c)


def dcn_reference(x, offset_mask, weight, bias=None, stride: int = 1,
                  modulation_scale: float = 2.0,
                  levels: Optional[Sequence[Tuple[int, int, int, int]]] = None
                  ) -> torch.Tensor:
    """Plain torch twin of K3: gathers, the 4-corner combine and one
    product with the weight, in the variant the dtypes pick.

    x (n, h, w, c) NHWC -> (n, ho, wo, cout); with ``levels`` (stride 1,
    ``offset_mask`` on the same canvas as x) -> (L, cout).
    """
    n, hc, wc, c = x.shape
    w3 = kernel_weight(weight) if weight.dim() == 4 else weight
    cout = w3.shape[-1]
    cdt = compute_dtype(x.dtype, w3.dtype)
    acc = torch.float64 if cdt == torch.float64 else torch.float32
    sampled = sampled_stack(x, offset_mask, stride, modulation_scale, levels,
                            acc)
    sampled = sampled.to(cdt).to(acc)  # the operand of the product
    out = sampled @ w3.to(acc).reshape(TAPS * c, cout)
    if bias is not None:
        out = out + bias.to(cdt).to(acc)
    out = out.to(cdt)
    if levels is not None:
        return out
    ho, wo = output_hw(hc, wc, stride)
    return out.reshape(n, ho, wo, cout)


def _positions(om, rows: slice, ho: int, wo: int, stride: int):
    """Image index and sampling positions of the output rows ``rows`` of a
    level's flat (n ho wo, 27) ``om``: ``(img (r,), py, px (r, 9))``, in
    ``om``'s dtype and level-local coordinates."""
    dt = om.dtype
    dev = om.device
    flat = torch.arange(rows.start, rows.stop, device=dev)
    img, rem = flat // (ho * wo), flat % (ho * wo)
    tap = torch.arange(TAPS, device=dev)
    off = om[rows, :2 * TAPS].reshape(-1, TAPS, 2)
    py = ((rem // wo) * stride).to(dt)[:, None] + (tap // 3 - 1).to(dt) \
        + off[..., 0]
    px = ((rem % wo) * stride).to(dt)[:, None] + (tap % 3 - 1).to(dt) \
        + off[..., 1]
    return img, py, px


def dcn_backward(x, offset_mask, weight3, grad_out, stride: int = 1,
                 modulation_scale: float = 2.0,
                 chunk_rows: int = BWD_CHUNK_ROWS,
                 levels: Optional[Sequence[Tuple[int, int, int, int]]] = None):
    """Gradients of :func:`dcn_reference` with respect to ``x`` (n, h, w,
    c), the raw ``offset_mask``, the kernel weight ``weight3`` (9, c, cout)
    and the bias, given ``grad_out`` (the forward's output shape). Plain
    torch ops, on either device, streamed over chunks of ``chunk_rows``
    output rows (``_bwd_chunked`` of the JAX package's ``custom_vjp``,
    ``pallas_dcn.py:199-248``)::

        s = sum_corner w4 * x[corner]     d_s = grad_out @ W^T
        d_W += s^T @ grad_out             d_w4 = <x[corner], d_s>
        d_x[corner] += w4 * d_s

    then ``d_w4`` to the offsets through the bilinear corner weights and to
    the mask logits through ``sigmoid * modulation_scale``. All of it runs
    in f32 (f64 for an f64 map), whatever the map's dtype (f32 or bf16),
    the weight's and ``grad_out``'s, with one cast to each input's dtype
    at the end; ``s`` is the unrounded f32 combine. A corner outside the
    map (with ``levels``: outside its level's region) has weight 0 and
    passes no gradient (``bilinear_sample.py``'s rule, which the JAX
    gradient follows). With ``levels`` (stride 1), ``x`` and
    ``offset_mask`` are canvases and ``grad_out`` is (L, cout) in the
    forward's level order; the gradients land in the regions and are 0
    in the gaps. Returns ``(d_x, d_offset_mask, d_weight3, d_bias)``,
    ``d_bias`` in f32 (f64).
    """
    n, hc, wc, c = x.shape
    cout = weight3.shape[-1]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    dev = x.device
    xf = x.reshape(n * hc * wc, c)
    go = grad_out.reshape(-1, cout)
    w_flat = weight3.to(acc).reshape(TAPS * c, cout)
    d_x = torch.zeros((n * hc * wc, c), dtype=acc, device=dev)
    d_w = torch.zeros_like(w_flat)
    if levels is None:
        ho, wo = output_hw(hc, wc, stride)
        parts = [((0, 0, hc, wc), stride, ho, wo)]
        d_om = None
    else:
        parts = [(tuple(r), 1, r[2], r[3]) for r in levels]
        d_om = torch.zeros(offset_mask.shape, dtype=acc, device=dev)
    out_start = 0
    for (y_org, x_org, h, w), lvl_stride, ho, wo in parts:
        om = (offset_mask if levels is None else
              offset_mask[:, y_org:y_org + h, x_org:x_org + w])
        om = om.reshape(-1, 3 * TAPS).to(acc)
        length = n * ho * wo
        d_om_l = torch.empty((length, 3 * TAPS), dtype=acc, device=dev)
        for start in range(0, length, chunk_rows):
            rows = slice(start, min(length, start + chunk_rows))
            img, py, px = _positions(om, rows, ho, wo, lvl_stride)
            img_row = img[:, None] * hc
            if y_org:
                img_row = img_row + y_org
            sig = torch.sigmoid(om[rows, 2 * TAPS:])
            mod = sig * modulation_scale
            y0, x0 = torch.floor(py), torch.floor(px)
            wy, wx = py - y0, px - x0
            cw = [(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx),
                  wy * wx]
            go_c = go[out_start + rows.start:out_start + rows.stop].to(acc)
            d_s = (go_c @ w_flat.T).reshape(-1, TAPS, c)
            s = torch.zeros_like(d_s)
            d_cw, d_mod = [], torch.zeros_like(mod)
            for k in range(4):
                yy, xx = y0 + (k >> 1), x0 + (k & 1)
                inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) \
                    & (xx <= w - 1)
                col = xx.clamp(0, w - 1).long()
                if x_org:
                    col = col + x_org
                row = torch.where(
                    inside, (img_row + yy.clamp(0, h - 1).long()) * wc
                    + col, 0)
                g = xf[row].to(acc)                        # (r, 9, c)
                wk = torch.where(inside, cw[k] * mod, 0)
                s += g * wk[..., None]
                d_x.index_add_(0, row.reshape(-1),
                               (wk[..., None] * d_s).reshape(-1, c))
                dw4 = torch.where(inside, (g * d_s).sum(-1), 0)
                del g
                d_cw.append(dw4 * mod)
                d_mod += dw4 * cw[k]
            d_w += s.reshape(-1, TAPS * c).T @ go_c
            d_om_l[rows, 0:2 * TAPS:2] = (1 - wx) * (d_cw[2] - d_cw[0]) \
                + wx * (d_cw[3] - d_cw[1])
            d_om_l[rows, 1:2 * TAPS:2] = (1 - wy) * (d_cw[1] - d_cw[0]) \
                + wy * (d_cw[3] - d_cw[2])
            d_om_l[rows, 2 * TAPS:] = d_mod * modulation_scale * sig \
                * (1 - sig)
        if levels is None:
            d_om = d_om_l
        else:
            d_om[:, y_org:y_org + h, x_org:x_org + w] = d_om_l.reshape(
                n, h, w, 3 * TAPS)
        out_start += length
    return (d_x.reshape(x.shape).to(x.dtype),
            d_om.reshape(offset_mask.shape).to(offset_mask.dtype),
            d_w.reshape(weight3.shape).to(weight3.dtype),
            go.sum(0, dtype=acc))


class DCNFunction(torch.autograd.Function):
    """K3 with a gradient: the kernel's forward (the twin on a CPU tensor)
    and :func:`dcn_backward`. Takes an f32 or bf16 map (f64 too on the
    CPU), with or without a level table; the weight in the kernel's (9, c,
    cout) layout and the bias in any float dtype (the parameters'): both
    are cast to the map's dtype for the forward, and their gradients come
    back in their own dtype."""

    @staticmethod
    def forward(ctx, x, offset_mask, weight3, bias, stride, modulation_scale,
                levels):
        ctx.save_for_backward(x, offset_mask, weight3)
        ctx.stride, ctx.modulation_scale = stride, modulation_scale
        ctx.levels = levels
        ctx.bias_dtype = None if bias is None else bias.dtype
        w3 = weight3.to(x.dtype)
        b = None if bias is None else bias.to(x.dtype)
        if x.device.type == 'cuda':
            return dcn_forward_cuda(
                x.contiguous(), offset_mask.float().contiguous(),
                w3.contiguous(), b, stride, modulation_scale, levels)
        return dcn_reference(x, offset_mask, w3, b, stride,
                             modulation_scale, levels)

    @staticmethod
    def backward(ctx, grad_out):
        x, offset_mask, weight3 = ctx.saved_tensors
        d_x, d_om, d_w, d_b = dcn_backward(
            x, offset_mask, weight3, grad_out, ctx.stride,
            ctx.modulation_scale, chunk_rows=BWD_CHUNK_ROWS,
            levels=ctx.levels)
        return (d_x, d_om, d_w, None if ctx.bias_dtype is None
                else d_b.to(ctx.bias_dtype), None, None, None)


def _check(name, t, shape, device, dtypes):
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype not in dtypes:
        raise TypeError(f'{name}: dtype {t.dtype}, the kernel takes '
                        f'{[str(d) for d in dtypes]}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected {shape}')
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f'{name}: not contiguous and 16-byte aligned')


def dcn_forward_cuda(x, offset_mask, weight3, bias=None, stride: int = 1,
                     modulation_scale: float = 2.0,
                     levels: Optional[Sequence[Tuple[int, int, int, int]]]
                     = None) -> torch.Tensor:
    """Launch K3 on CUDA tensors. ``weight3`` is in the kernel's (9, c,
    cout) layout (:func:`kernel_weight`); bias and output are in the
    kernel dtype; ``offset_mask`` is read as f32."""
    global launches, launches_bf16, launches_int8
    from ..kernels import check_launch, load_library

    device = x.device
    if device.type != 'cuda':
        raise ValueError(f'dcn_forward_cuda needs CUDA tensors, got {device}')
    n, hc, wc, c = x.shape
    cout = weight3.shape[-1]
    if x.dtype not in _TYPE_CODE:
        raise TypeError(f'x: dtype {x.dtype}, K3 takes f32, bf16 or int8')
    cdt = compute_dtype(x.dtype, weight3.dtype)
    w_types = ((torch.float32, torch.bfloat16) if x.dtype == torch.int8
               else (x.dtype,))
    chunk = 64 // x.element_size()
    if c % chunk or cout % 4:
        raise ValueError(f'K3 takes c % {chunk} == 0 ({x.dtype} map) and '
                         f'cout % 4 == 0; got c={c}, cout={cout}')
    if levels is None:
        ho, wo = output_hw(hc, wc, stride)
        table = [(0, 0, hc, wc, ho, wo)]
        om_shape = (n, ho, wo, 3 * TAPS)
        out_shape = (n, ho, wo, cout)
    else:
        if stride != 1:
            raise ValueError('a level table runs at stride 1')
        if not 1 <= len(levels) <= MAX_LEVELS:
            raise ValueError(f'K3 takes 1-{MAX_LEVELS} levels, got '
                             f'{len(levels)}')
        for y0, x0, h, w in levels:
            if y0 < 0 or x0 < 0 or y0 + h > hc or x0 + w > wc:
                raise ValueError(f'level ({y0}, {x0}, {h}, {w}) outside the '
                                 f'{hc}x{wc} canvas')
        table = [(y0, x0, h, w, h, w) for y0, x0, h, w in levels]
        om_shape = (n, hc, wc, 3 * TAPS)
        out_shape = (n * sum(h * w for _, _, h, w in levels), cout)
    if n * hc * wc * c >= 2 ** 31 or out_shape[0] * cout >= 2 ** 31 \
            or n * hc * wc * 3 * TAPS >= 2 ** 31:
        raise ValueError('K3 indexes with 32-bit offsets; input too large')
    _check('x', x, (n, hc, wc, c), device, (x.dtype,))
    _check('offset_mask', offset_mask, om_shape, device, (torch.float32,))
    _check('weight3', weight3, (TAPS, c, cout), device, w_types)
    if bias is not None:
        _check('bias', bias, (cout,), device, (cdt,))
    lib = load_library()
    out = torch.empty(out_shape, dtype=cdt, device=device)
    flat = [v for row in table for v in row]
    table_c = (ctypes.c_int * len(flat))(*flat)
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        None if t is None else t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.epropnp_dcn_forward(
            ptr(x), ptr(offset_mask), ptr(weight3), ptr(bias), ptr(out),
            ctypes.cast(table_c, ctypes.c_void_p), len(table), n, hc, wc,
            om_shape[1], om_shape[2], c, cout, stride, modulation_scale,
            _TYPE_CODE[x.dtype], _TYPE_CODE[cdt], ctypes.c_void_p(stream))
    check_launch(err, 'epropnp_dcn_forward')
    if x.dtype == torch.int8:
        launches_int8 += 1
    elif x.dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def dcn_forward(x, offset_mask, weight, bias=None, stride: int = 1,
                modulation_scale: float = 2.0,
                levels: Optional[Sequence[Tuple[int, int, int, int]]] = None
                ) -> torch.Tensor:
    """K3 entry: the CUDA kernel for CUDA tensors, the twin for CPU tensors.

    ``weight`` is mmcv's (cout, c, 3, 3) or the kernel's (9, c, cout).
    On the card the bias is cast to the kernel dtype and the offsets to
    f32. Any other device raises. Where grad is enabled and an input
    requires it, an f32 or bf16 map (f64 too on the CPU), with or without
    a level table, goes through :class:`DCNFunction` (the weight and the
    bias in any float dtype, cast to the map's); the int8 map raises.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset_mask, weight, bias)):
        w3 = kernel_weight(weight) if weight.dim() == 4 else weight
        grad_types = ((torch.float32, torch.bfloat16)
                      if x.device.type == 'cuda'
                      else (torch.float32, torch.float64, torch.bfloat16))
        if x.dtype not in grad_types:
            raise NotImplementedError(
                f'dcn_forward: the {x.dtype} map is forward only (the int8 '
                'map serves; JAX\'s dcn_gather_contract_q has no gradient); '
                'run it under torch.no_grad()')
        if x.device.type not in ('cuda', 'cpu'):
            raise ValueError(f'dcn_forward: unsupported device {x.device}')
        return DCNFunction.apply(
            x, offset_mask, w3, bias, stride, modulation_scale,
            None if levels is None else tuple(map(tuple, levels)))
    if x.device.type == 'cuda':
        w3 = kernel_weight(weight) if weight.dim() == 4 else weight
        cdt = compute_dtype(x.dtype, w3.dtype)
        return dcn_forward_cuda(
            x.contiguous(), offset_mask.float().contiguous(),
            w3.contiguous(), None if bias is None else bias.to(cdt),
            stride, modulation_scale, levels)
    if x.device.type == 'cpu':
        return dcn_reference(x, offset_mask, weight, bias, stride,
                             modulation_scale, levels)
    raise ValueError(f'dcn_forward: unsupported device {x.device}')
