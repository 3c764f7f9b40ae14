"""The port's flax-msgpack reader against files the JAX package writes.

``utils.checkpoint.read_flax_msgpack`` decodes ``flax.serialization.
to_bytes`` in pure Python; each file here is written by the JAX package's
``utils.checkpoint.save_checkpoint`` into ``tmp_path`` and must read back
bit for bit. The reader module imports neither ``msgpack`` nor ``flax``
(checked in a fresh interpreter).
"""

import subprocess
import sys

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import struct

from epropnp_tpu.utils.checkpoint import save_checkpoint
from epropnp_tpu_torch.utils.checkpoint import (load_jax_variables,
                                                read_flax_msgpack)


def _tree(seed):
    r = np.random.default_rng(seed)
    return {
        'params': {
            'dense': {'kernel': r.normal(size=(3, 5)).astype(np.float32),
                      'bias': r.normal(size=(5,)).astype(np.float32)},
            'f64': r.normal(size=(2, 2, 3)),
            'ints': r.integers(-2 ** 40, 2 ** 40, (7,)),
            'i32': r.integers(-9, 9, (4, 1)).astype(np.int32),
            'bf16': jnp.asarray(r.normal(size=(6, 4)), jnp.bfloat16),
            'empty': np.zeros((0, 3), np.float32),
            'flag': np.array([True, False]),
        },
        'batch_stats': {'bn': {'mean': r.normal(size=(8,)).astype(
            np.float32)}},
        'nested': (r.normal(size=(3,)).astype(np.float32),
                   (np.arange(70000, dtype=np.int64),
                    jnp.asarray(1.5, jnp.bfloat16)),
                   [np.float32(2.5), np.int32(-3)]),
        'step': jnp.asarray(7, jnp.int32),
    }


def _assert_same(got, want, path=''):
    """``want`` as flax's state dict holds it: a tuple or list becomes a
    dict keyed '0', '1', ...; bf16 leaves come back as torch bf16."""
    if isinstance(want, (tuple, list)):
        want = {str(i): v for i, v in enumerate(want)}
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f'{path}/{k}')
        return
    if np.asarray(want).dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want, np.float32), err_msg=path)
        return
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_reader_reads_jax_checkpoint_bit_for_bit(tmp_path):
    """f32, f64, int32/int64 and bool arrays, bf16 leaves, a 0-size array,
    numpy scalars and nested tuples and lists."""
    tree = _tree(0)
    path = save_checkpoint(str(tmp_path / 'tree.msgpack'), tree)
    _assert_same(read_flax_msgpack(path), tree)


class _State(struct.PyTreeNode):
    params: dict
    batch_stats: dict
    opt_state: tuple
    step: jnp.ndarray


def test_load_jax_variables_from_train_state(tmp_path):
    """A train-state file (a flax struct with more entries) and a variables
    file give the same ``{'params', 'batch_stats'}``; bf16 leaves come
    back as their exact float32 values."""
    tree = _tree(1)
    state = _State(params=tree['params'], batch_stats=tree['batch_stats'],
                   opt_state=(tree['params'], jnp.zeros(())),
                   step=jnp.asarray(3))
    p_state = save_checkpoint(str(tmp_path / 'state.msgpack'), state)
    p_vars = save_checkpoint(str(tmp_path / 'vars.msgpack'), {
        'params': tree['params'], 'batch_stats': tree['batch_stats']})
    for path in (p_state, p_vars):
        out = load_jax_variables(path)
        assert set(out) == {'params', 'batch_stats'}
        assert out['params']['bf16'].dtype == np.float32
        np.testing.assert_array_equal(
            out['params']['bf16'],
            np.asarray(tree['params']['bf16'], np.float32))
        _assert_same(out['batch_stats'], tree['batch_stats'])
        _assert_same(out['params']['dense'], tree['params']['dense'])


def test_reader_refuses_chunked_leaves_and_other_files(tmp_path):
    """A chunked array leaf (flax splits leaves over 2**30 bytes) is
    refused with a clear error; so are ext types flax does not write, a
    truncated file and a file without params."""
    chunked = {'params': {'w': {'__msgpack_chunked_array__': True,
                                'shape': [2], 'chunks': {}}}}
    path = tmp_path / 'chunked.msgpack'
    path.write_bytes(msgpack.packb(chunked))
    with pytest.raises(ValueError, match='chunked array leaf'):
        read_flax_msgpack(str(path))
    path = tmp_path / 'ext.msgpack'
    path.write_bytes(msgpack.packb({'x': msgpack.ExtType(9, b'ab')}))
    with pytest.raises(ValueError, match='ext type 9'):
        read_flax_msgpack(str(path))
    good = save_checkpoint(str(tmp_path / 'good.msgpack'), _tree(2))
    path = tmp_path / 'cut.msgpack'
    path.write_bytes(open(good, 'rb').read()[:-5])
    with pytest.raises(ValueError, match='ends early'):
        read_flax_msgpack(str(path))
    no_params = save_checkpoint(str(tmp_path / 'np.msgpack'),
                                {'step': np.int32(1)})
    with pytest.raises(ValueError, match='no params'):
        load_jax_variables(no_params)


def test_reader_imports_neither_msgpack_nor_flax():
    code = ('import sys; import epropnp_tpu_torch.utils.checkpoint; '
            'bad = [m for m in ("msgpack", "flax", "jax") '
            'if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
