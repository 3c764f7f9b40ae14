"""Dotted-path overrides for frozen dataclass configs (a copy of
``epropnp_tpu/utils/config_override.py``).

The reference mutates live module attributes at runtime — mmcv's
``--cfg-options``, the eval-time ``test_cfg.override_cfg`` rewrites
(deform_pnp_head.py:226-228,332-342), and the scheduled ``ModelUpdaterHook``
(runner/hooks/model_updater.py:11-60). With immutable dataclass configs the
same capability is a pure function: ``override(cfg, {'pnp.lm_num_iter': 5})``
returns a new config tree (the train->eval solver-iteration override ships
as ``DetPnPConfig.test_lm_num_iter``).

``ScheduledOverrides`` replays the ModelUpdaterHook semantics: a list of
(step, overrides) applied when training crosses each step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple


def override(cfg: Any, updates: Dict[str, Any]) -> Any:
    """Return a copy of a (nested) frozen dataclass with dotted updates."""
    for path, value in updates.items():
        cfg = _set_path(cfg, path.split('.'), value)
    return cfg


def _set_path(node: Any, parts: Sequence[str], value: Any) -> Any:
    key = parts[0]
    if len(parts) == 1:
        return dataclasses.replace(node, **{key: value})
    child = getattr(node, key)
    return dataclasses.replace(node,
                               **{key: _set_path(child, parts[1:], value)})


class ScheduledOverrides:
    """Apply config overrides when training reaches given steps/epochs."""

    def __init__(self, schedule: List[Tuple[int, Dict[str, Any]]]):
        self.schedule = sorted(schedule)
        self._applied = [False] * len(self.schedule)

    def maybe_apply(self, cfg: Any, step: int) -> Tuple[Any, bool]:
        changed = False
        for i, (at, updates) in enumerate(self.schedule):
            if not self._applied[i] and step >= at:
                cfg = override(cfg, updates)
                self._applied[i] = True
                changed = True
        return cfg, changed
