"""LineMOD dataset constants (a copy of
``epropnp_tpu/sixdof/ref_constants.py``). Reference:
EPro-PnP-6DoF/lib/ref.py:25-62."""

from __future__ import annotations

import numpy as np

LM_OBJECTS = ['ape', 'benchvise', 'camera', 'can', 'cat', 'driller', 'duck',
              'eggbox', 'glue', 'holepuncher', 'iron', 'lamp', 'phone']
LMO_OBJECTS = ['ape', 'can', 'cat', 'driller', 'duck', 'eggbox', 'glue',
               'holepuncher']

IDX2OBJ = {
    1: 'ape', 2: 'benchvise', 3: 'bowl', 4: 'camera', 5: 'can', 6: 'cat',
    7: 'cup', 8: 'driller', 9: 'duck', 10: 'eggbox', 11: 'glue',
    12: 'holepuncher', 13: 'iron', 14: 'lamp', 15: 'phone',
}
OBJ2IDX = {v: k for k, v in IDX2OBJ.items()}

IM_W, IM_H = 640, 480
CAMERA_MATRIX = np.array([[572.4114, 0., 325.2611],
                          [0., 573.57043, 242.04899],
                          [0., 0., 1.]])
