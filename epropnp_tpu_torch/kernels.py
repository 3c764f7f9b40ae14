"""Build and load the hand-written CUDA kernels of ``csrc/``, and the
package's host-side C++ libraries.

Each source is compiled with ``nvcc`` for ``sm_90a`` (one compiler process
per source, all started together), and the objects are linked into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The build runs at first use, from the package's own sources only, into
``build/`` beside the package; the file name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library never loads.
A missing compiler or a failed build raises.

:func:`build_host_library` builds a host-side C++ source (``ops/iou3d``,
the PNG filters of ``utils/image_ops``) with ``g++`` the same way.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), 'build')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                           '-Xptxas', '-v')
HOST_CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (see the ``extern "C"`` functions).
_SIGNATURES = {
    'epropnp_lm_solve': [_P] * 10 + [_I] * 6 + [_F] * 7 + [_P],
    'epropnp_rslm_init': [_P] * 9 + [_I] * 8 + [_F] * 7 + [_P],
    'epropnp_dcn_forward': [_P] * 6 + [_I] * 9 + [_F] + [_I] * 2 + [_P],
    'epropnp_lm_occupancy': [_I] * 6 + [_P],
    'epropnp_rslm_occupancy': [_I] * 5 + [_P],
}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu*'))):
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f'libepropnp_kernels_{h.hexdigest()[:16]}.so')


def build() -> str:
    """Compile ``csrc/*.cu`` unless the library is already built.

    Returns the library path. The compilers' output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it as
    ``<library>.log``.
    """
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f'{out}.{os.getpid()}.tmp'
    jobs = []
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu'))):
        obj = f'{tmp}.{os.path.basename(src)}.o'
        cmd = [nvcc, *NVCC_FLAGS, '-c', src, '-o', obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(' '.join(cmd) + '\n' + text)
        if proc.returncode != 0:
            failed.append(f'{cmd[-3]} ({proc.returncode})')
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, '-shared', '-o', tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        log.append(' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f'link ({proc.returncode})')
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(out + '.log', 'w') as f:
        f.write('\n'.join(log))
    if failed:
        raise RuntimeError(f'nvcc failed: {failed}\n' + '\n'.join(log))
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def build_host_library(src: str, build_dir: str = BUILD_DIR) -> str:
    """Compile the C++ source ``src`` with ``g++`` into a shared library
    in ``build_dir``, ``lib<stem>_<hash of source and flags>.so``, unless
    it is already built; returns its path. Raises ``RuntimeError`` naming
    the compiler when ``g++`` is missing or fails."""
    h = hashlib.sha256(' '.join(HOST_CXX_FLAGS).encode())
    with open(src, 'rb') as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(build_dir, f'lib{stem}_{h.hexdigest()[:16]}.so')
    if os.path.exists(out):
        return out
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError(f'g++ not found: {os.path.basename(src)} cannot '
                           'be built')
    os.makedirs(build_dir, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.run([cxx, *HOST_CXX_FLAGS, src, '-o', tmp],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed to build {os.path.basename(src)} '
                           f'({proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entries."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t {err}')
