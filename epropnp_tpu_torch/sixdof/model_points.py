"""LineMOD object model loading: PLY vertices + models_info metadata (a
copy of ``epropnp_tpu/sixdof/model_points.py``).

Counterpart of the reference's ``lib/utils/io.py:13`` (PLY vertex loader
feeding the ADD(-S) evaluation) and the ``models_info.txt`` parsing in
``lib/ref.py`` (per-class diameters and min extents used for coordinate
normalization and ADD thresholds).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_ply_vertices(path: str) -> np.ndarray:
    """Read the vertex positions of an ascii or binary little-endian PLY."""
    with open(path, 'rb') as f:
        if f.readline().strip() != b'ply':
            raise ValueError(f'{path} is not a PLY file')
        fmt = None
        n_verts = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line == b'end_header':
                break
            parts = line.split()
            if parts[0] == b'format':
                fmt = parts[1].decode()
            elif parts[0] == b'element':
                in_vertex = parts[1] == b'vertex'
                if in_vertex:
                    n_verts = int(parts[2])
            elif parts[0] == b'property' and in_vertex:
                props.append((parts[2].decode(), parts[1].decode()))

        type_map = {'float': 'f4', 'float32': 'f4', 'double': 'f8',
                    'uchar': 'u1', 'uint8': 'u1', 'char': 'i1',
                    'short': 'i2', 'ushort': 'u2', 'int': 'i4',
                    'uint': 'u4'}
        if fmt == 'ascii':
            data = np.loadtxt(f, max_rows=n_verts)
            names = [p[0] for p in props]
            xyz = data[:, [names.index('x'), names.index('y'),
                           names.index('z')]]
        else:
            endian = '<' if 'little' in fmt else '>'
            dtype = np.dtype([(name, endian + type_map[t])
                              for name, t in props])
            data = np.frombuffer(f.read(n_verts * dtype.itemsize),
                                 dtype=dtype, count=n_verts)
            xyz = np.stack([data['x'], data['y'], data['z']], axis=-1)
        return np.ascontiguousarray(xyz, np.float64)


def load_models_info(path: str) -> Dict[int, Dict[str, float]]:
    """Parse a LineMOD ``models_info`` file (txt or yml-like).

    Returns {obj_id: {'diameter', 'min_x', 'min_y', 'min_z', ...}} in the
    same units as the file (the reference stores millimeters and divides
    by 1000 downstream).
    """
    out: Dict[int, Dict[str, float]] = {}
    with open(path) as f:
        text = f.read()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        # formats: "1: diameter: 102.09, min_x: -37.9, ..." or
        # "1 diameter 102.09 min_x -37.9 ..."
        norm = line.replace(':', ' ').replace(',', ' ')
        parts = norm.split()
        if not parts or not parts[0].lstrip('-').isdigit():
            continue
        obj_id = int(parts[0])
        kv = parts[1:]
        entry = {}
        for k, v in zip(kv[0::2], kv[1::2]):
            try:
                entry[k] = float(v)
            except ValueError:
                continue
        if entry:
            out[obj_id] = entry
    return out
