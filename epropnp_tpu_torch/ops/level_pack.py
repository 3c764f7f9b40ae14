"""Pack an FPN pyramid into one composite map (PyTorch, NHWC), counterpart
of ``epropnp_tpu/ops/level_pack.py``.

The FCOS towers run shared-weight convs over 5 pyramid levels; packing the
levels into one canvas runs each conv once. Exactness rules:

* Levels are separated by a ``gap`` of >= 2 zero pixels and the layout
  leaves >= 1 zero at the canvas edge wherever a level touches it via its
  gap. A 3x3 conv then sees exactly the zeros per-level 'same' padding
  would give, provided the gaps are zero again before the next conv
  (``map_levels`` rebuilds the canvas on zeros, ``rezero_gaps`` zeroes it).
* GroupNorm statistics are per level: apply it to each level's slice
  (``map_levels``).
* A deformable conv must not sample across level borders:
  ``DeformConv.forward(x, layout=...)`` samples each level's region with
  level-local validity (``ops/deform_conv.py``).

``plan_level_packing`` is a copy of the JAX package's planner (pure
Python), so both packages place the levels at the same origins.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch


class LevelLayout:
    """Static placement of pyramid levels on one canvas.

    Attributes:
        shapes: per-level (h, w).
        origins: per-level (y, x) canvas offsets.
        canvas_hw: (H, W) canvas shape.
        gap: zero-pixel separation between regions.
    """

    def __init__(self, shapes, origins, canvas_hw, gap):
        self.shapes = [tuple(s) for s in shapes]
        self.origins = [tuple(o) for o in origins]
        self.canvas_hw = tuple(canvas_hw)
        self.gap = gap

    def regions(self) -> List[Tuple[int, int, int, int]]:
        """Per level (y0, x0, h, w), the level table K3 takes."""
        return [(y, x, h, w)
                for (h, w), (y, x) in zip(self.shapes, self.origins)]

    def mask(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """(H, W, 1) canvas mask: 1 inside level regions."""
        m = torch.zeros(self.canvas_hw + (1,), dtype=dtype, device=device)
        for y, x, h, w in self.regions():
            m[y:y + h, x:x + w] = 1
        return m

    def waste(self) -> float:
        """Fraction of canvas pixels outside any level region."""
        used = sum(h * w for h, w in self.shapes)
        return 1.0 - used / (self.canvas_hw[0] * self.canvas_hw[1])


def plan_level_packing(shapes: Sequence[Tuple[int, int]],
                       gap: int = 2) -> LevelLayout:
    """Shelf-pack pyramid levels (descending size) onto one canvas.

    Level 0 anchors the canvas width; later levels fill left-to-right
    shelves below it, wrapping when a row would overflow.
    """
    if not shapes:
        raise ValueError('no level shapes')
    h0, w0 = shapes[0]
    width = w0
    origins = [(0, 0)]
    shelf_y = h0 + gap
    shelf_h = 0
    cur_x = 0
    for h, w in shapes[1:]:
        if cur_x and cur_x + w > width:
            shelf_y += shelf_h + gap
            shelf_h = 0
            cur_x = 0
        if w > width:  # pathological (non-descending) input
            width = w
        origins.append((shelf_y, cur_x))
        cur_x += w + gap
        shelf_h = max(shelf_h, h)
    canvas = (shelf_y + shelf_h, width)
    return LevelLayout(shapes, origins, canvas, gap)


def pack_levels(feats: Sequence[torch.Tensor],
                layout: LevelLayout) -> torch.Tensor:
    """Per-level (n, h, w, c) maps -> (n, H, W, c) composite (gaps zero)."""
    n, _, _, c = feats[0].shape
    comp = feats[0].new_zeros((n,) + layout.canvas_hw + (c,))
    for f, (y, x, h, w) in zip(feats, layout.regions()):
        comp[:, y:y + h, x:x + w] = f
    return comp


def unpack_levels(comp: torch.Tensor, layout: LevelLayout
                  ) -> List[torch.Tensor]:
    """(n, H, W, c) composite -> per-level (n, h, w, c) views."""
    return [comp[:, y:y + h, x:x + w] for y, x, h, w in layout.regions()]


def map_levels(comp: torch.Tensor, layout: LevelLayout,
               fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Apply ``fn`` to each level's slice and write it into a zero canvas
    (for ops whose statistics stay per level, as GroupNorm's)."""
    return pack_levels([fn(s) for s in unpack_levels(comp, layout)], layout)


def rezero_gaps(comp: torch.Tensor, layout: LevelLayout) -> torch.Tensor:
    """Zero everything outside level regions."""
    return comp * layout.mask(comp.dtype, comp.device)
