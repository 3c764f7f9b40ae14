"""K3: the DCNv2 sampling contraction, and its plain twin.

``dcn_forward`` is what ``DeformConv`` calls. On a CUDA tensor it launches
the hand-written kernel of ``csrc/dcn_kernel.cu`` (an implicit GEMM that
gathers the 4 bilinear corners of every tap from the NHWC map itself) or
raises; on a CPU tensor it runs :func:`dcn_reference`, the same function
written with torch gathers and one product with the weight.

For every output position (img, i, j) and output channel o::

    out = bias[o] + sum_tap sum_ci bilinear_zeros(x[img], p_tap)[ci]
                                   * mod_tap * W[o, ci, tap]
    p_tap = (j s + dx_tap + off_x, i s + dy_tap + off_y)       in [x, y]
    mod_tap = sigmoid(mask_tap) * modulation_scale

with (dx_tap, dy_tap) in {-1, 0, 1}^2 row-major by (dy, dx). Layouts are
mmcv's: ``offset_mask`` is the raw ``conv_offset`` output, (n, ho, wo, 27)
NHWC with (dy, dx) for each tap then the 9 mask logits, and ``weight`` is
(cout, c, 3, 3). A corner outside the map contributes 0.

Forward only: the backward (``_bwd_chunked`` in the JAX package) comes
with Det training, so the wrapper refuses inputs that require grad while
grad is enabled.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

TAPS = 9

# Launches of the CUDA kernel, counted by :func:`dcn_forward_cuda` alone.
launches = 0


def output_hw(h: int, w: int, stride: int):
    """Output size of a 3x3 conv with padding 1 (torch geometry)."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """mmcv weight (cout, c, 3, 3) -> the kernel's (9, c, cout) layout."""
    cout, c = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(TAPS, c, cout).contiguous()


def corner_rows_and_weights(offset_mask, h, w, stride, modulation_scale):
    """Flat row indices into ``x.reshape(-1, c)`` (per image block of h*w
    rows) and the 4 corner weights with validity and modulation folded in.

    Returns ``(rows, w4)``, each (n, ho, wo, 9, 4): corners ordered
    [y0x0, y0x1, y1x0, y1x1]; an invalid corner has row 0 and weight 0.
    """
    n, ho, wo, _ = offset_mask.shape
    dt, dev = offset_mask.dtype, offset_mask.device
    off = offset_mask[..., :2 * TAPS].reshape(n, ho, wo, TAPS, 2)
    mod = torch.sigmoid(offset_mask[..., 2 * TAPS:]) * modulation_scale
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
        yc = yy.clamp(0, h - 1).long()
        xc = xx.clamp(0, w - 1).long()
        rows.append(torch.where(inside, (img * h + yc) * w + xc, 0))
        weights.append(torch.where(inside, cw[k] * mod, 0))
    return torch.stack(rows, -1), torch.stack(weights, -1)


def dcn_reference(x, offset_mask, weight, bias=None, stride: int = 1,
                  modulation_scale: float = 2.0) -> torch.Tensor:
    """Plain torch twin of K3: gathers, the 4-corner combine and one
    product with the weight. x (n, h, w, c) NHWC -> (n, ho, wo, cout)."""
    n, h, w, c = x.shape
    cout = weight.shape[0]
    ho, wo = output_hw(h, w, stride)
    rows, w4 = corner_rows_and_weights(offset_mask, h, w, stride,
                                       modulation_scale)
    flat = x.reshape(n * h * w, c)
    sampled = sum(flat[rows[..., k]] * w4[..., k, None] for k in range(4))
    out = sampled.reshape(n * ho * wo, TAPS * c) @ kernel_weight(
        weight).reshape(TAPS * c, cout)
    if bias is not None:
        out = out + bias
    return out.reshape(n, ho, wo, cout)


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype != torch.float32:
        raise TypeError(f'{name}: dtype {t.dtype}, the kernel takes float32')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected {shape}')
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f'{name}: not contiguous and 16-byte aligned')


def dcn_forward_cuda(x, offset_mask, weight3, bias=None, stride: int = 1,
                     modulation_scale: float = 2.0) -> torch.Tensor:
    """Launch K3 on CUDA tensors. ``weight3`` is already in the kernel's
    (9, c, cout) layout (:func:`kernel_weight`)."""
    global launches
    from ..kernels import check_launch, load_library

    device = x.device
    if device.type != 'cuda':
        raise ValueError(f'dcn_forward_cuda needs CUDA tensors, got {device}')
    n, h, w, c = x.shape
    cout = weight3.shape[-1]
    ho, wo = output_hw(h, w, stride)
    if c % 16 or cout % 4:
        raise ValueError(f'K3 takes c % 16 == 0 and cout % 4 == 0; got c={c}'
                         f', cout={cout}')
    if n * h * w * c >= 2 ** 31 or n * ho * wo * cout >= 2 ** 31:
        raise ValueError('K3 indexes with 32-bit offsets; input too large')
    _check('x', x, (n, h, w, c), device)
    _check('offset_mask', offset_mask, (n, ho, wo, 3 * TAPS), device)
    _check('weight3', weight3, (TAPS, c, cout), device)
    if bias is not None:
        _check('bias', bias, (cout,), device)
    lib = load_library()
    out = torch.empty((n, ho, wo, cout), dtype=torch.float32, device=device)
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        None if t is None else t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.epropnp_dcn_forward(
            ptr(x), ptr(offset_mask), ptr(weight3), ptr(bias), ptr(out), n,
            h, w, c, ho, wo, cout, stride, modulation_scale,
            ctypes.c_void_p(stream))
    check_launch(err, 'epropnp_dcn_forward')
    launches += 1
    return out


def dcn_forward(x, offset_mask, weight, bias=None, stride: int = 1,
                modulation_scale: float = 2.0,
                weight3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 entry: the CUDA kernel for CUDA tensors, the twin for CPU tensors.

    ``weight`` is mmcv's (cout, c, 3, 3); ``weight3`` may pass its kernel
    layout, computed once by the caller. Any other device raises, and so
    does an input that requires grad while grad is enabled (no backward).
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset_mask, weight, bias)):
        raise NotImplementedError(
            'dcn_forward is forward only: run it under torch.no_grad() (the '
            'DCN backward comes with Det training)')
    if x.device.type == 'cuda':
        if weight3 is None:
            weight3 = kernel_weight(weight)
        return dcn_forward_cuda(x.contiguous(), offset_mask.contiguous(),
                                weight3, bias, stride, modulation_scale)
    if x.device.type == 'cpu':
        return dcn_reference(x, offset_mask, weight, bias, stride,
                             modulation_scale)
    raise ValueError(f'dcn_forward: unsupported device {x.device}')
