"""Checkpoint save/restore of a training state (PyTorch).

Counterpart of ``epropnp_tpu/utils/checkpoint.py``: one file holds the
state's ``state_dict()`` (parameters, BatchNorm statistics, the Monte Carlo
loss's EMA buffer, the step) and the optimizer's (``torch.save``). Writes
are atomic (a temporary file, then ``os.replace``), so a run stopped
mid-write leaves the previous checkpoint whole. ``filter_fn`` restores only
the top-level entries it selects (the reference's key-filtered
``load_model``, EPro-PnP-6DoF/lib/model.py:79-113).

The JAX package writes its checkpoints with ``flax.serialization.to_bytes``
(msgpack). :func:`read_flax_msgpack` decodes such a file in pure Python,
without ``msgpack`` or ``flax``; :func:`load_jax_variables` takes its
``params`` and ``batch_stats``, which ``utils.convert.cdpn_state_dict`` and
``det_state_dict`` map onto the port's models.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

# flax/serialization.py: arrays above this many bytes are written in
# chunks (``_chunk``); no leaf of the repository's models comes near it
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# suffixes of a torch checkpoint; any other file is read as flax msgpack
TORCH_SUFFIXES = ('.pth', '.pt', '.tar')
# msgpack tags with a length field: (its struct format, the kind)
_SIZED = {0xc4: ('B', 'bin'), 0xc5: ('H', 'bin'), 0xc6: ('I', 'bin'),
          0xd9: ('B', 'str'), 0xda: ('H', 'str'), 0xdb: ('I', 'str'),
          0xdc: ('H', 'array'), 0xdd: ('I', 'array'),
          0xde: ('H', 'map'), 0xdf: ('I', 'map'),
          0xc7: ('B', 'ext'), 0xc8: ('H', 'ext'), 0xc9: ('I', 'ext')}
# msgpack scalar tags: their struct format
_SCALARS = {0xca: 'f', 0xcb: 'd', 0xcc: 'B', 0xcd: 'H', 0xce: 'I',
            0xcf: 'Q', 0xd0: 'b', 0xd1: 'h', 0xd2: 'i', 0xd3: 'q'}
_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}


def save_checkpoint(path: str, state) -> str:
    """``state``: a module with a ``tx`` optimizer (``sixdof.train.
    TrainState`` or ``det.train.DetTrainState``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + '.tmp'
    torch.save({'state': state.state_dict(),
                'optimizer': state.tx.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state,
                    filter_fn: Optional[Callable[[str], bool]] = None):
    """Restore ``state`` in place from ``path`` and return it.

    ``filter_fn(key)`` picks among the top-level entries ``'params'``
    (parameters), ``'batch_stats'`` (BatchNorm buffers), ``'mc_state'``
    (the 6DoF ``norm_factor``), ``'ema'`` (the Det ``ema_*`` buffers),
    ``'step'`` and ``'opt_state'``; None restores all of them.
    """
    data = torch.load(path, map_location='cpu', weights_only=True)
    keep = filter_fn or (lambda key: True)
    params = {n for n, _ in state.named_parameters()}

    def entry(name):
        if name in params:
            return 'params'
        if name == 'norm_factor':
            return 'mc_state'
        if name.startswith('ema_'):
            return 'ema'
        if name == 'step':
            return 'step'
        return 'batch_stats'

    current = state.state_dict()
    current.update({k: v for k, v in data['state'].items()
                    if keep(entry(k))})
    state.load_state_dict(current)
    if keep('opt_state'):
        state.tx.load_state_dict(data['optimizer'])
    return state


class _Reader:
    """A decoder of the msgpack subset ``flax.serialization.to_bytes``
    writes: maps, arrays, str/bin, ints, floats, nil, bools and the ext
    types 1 (ndarray) and 3 (numpy scalar)."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('msgpack data ends early')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack('>' + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack('B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), 'utf-8')
        if b in _FIXED:
            return _FIXED[b]
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            n = self.unpack(fmt)
            if kind == 'bin':
                return bytes(self.take(n))
            if kind == 'str':
                return str(self.take(n), 'utf-8')
            if kind == 'array':
                return self.array(n)
            if kind == 'map':
                return self.map(n)
            return self.ext(self.unpack('b'), n)
        if 0xd4 <= b <= 0xd8:  # fixext 1, 2, 4, 8, 16
            return self.ext(self.unpack('b'), 1 << (b - 0xd4))
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        raise ValueError(f'msgpack tag 0x{b:02x} is not in the subset flax '
                         'writes')

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if out.get('__msgpack_chunked_array__'):
            raise ValueError(
                'chunked array leaf (over MAX_CHUNK_SIZE = 2**30 bytes): not '
                'supported; no leaf of the repository\'s models comes near '
                'that size')
        return out

    def ext(self, code: int, n: int):
        body = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f'msgpack ext type {code} is not supported')
        shape, dtype, buf = _Reader(body).value()
        arr = _array(tuple(shape), dtype, buf)
        return arr if code == _EXT_NDARRAY else arr[()]


def _array(shape, dtype_name, buf: bytes):
    """flax's ``_ndarray_from_bytes``: C-order bytes of ``dtype_name``. A
    ``bfloat16`` leaf becomes a torch bf16 tensor (numpy has no such
    type); every other leaf a writable numpy array."""
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == 'bfloat16':
        if not buf:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                                ).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(
        shape).copy()


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """A file of ``flax.serialization.to_bytes`` (the JAX package's
    ``utils.checkpoint.save_checkpoint``) -> its state dict: nested dicts
    (a tuple or list of the saved tree is a dict keyed ``'0'``, ``'1'``,
    ...), numpy arrays and scalars, bf16 leaves as torch tensors."""
    with open(path, 'rb') as f:
        reader = _Reader(f.read())
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f'{path}: trailing bytes after the msgpack object')
    return out


def _float32_leaves(tree):
    """bf16 tensors -> float32 numpy (exact); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _float32_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def load_jax_variables(path: str) -> Dict[str, Dict]:
    """``{'params', 'batch_stats'}`` of a JAX checkpoint (msgpack): a
    variables file or a train state (``sixdof.train.TrainState``,
    ``det.train.DetTrainState``), whose entries hold the same trees. bf16
    leaves (a ``v1b_serving`` DCN) come back as float32, which is exact:
    the port's parameters are f32."""
    data = read_flax_msgpack(path)
    if 'params' not in data:
        raise ValueError(f'{path}: no params entry (not a flax variables '
                         'or train-state file)')
    return {'params': _float32_leaves(data['params']),
            'batch_stats': _float32_leaves(data.get('batch_stats') or {})}
