"""Stage timers with device synchronisation (PyTorch), counterpart of
``epropnp_tpu/utils/timer.py`` and of the reference's ``IterTimer`` /
``IterTimers`` (EPro-PnP-Det/epropnp_det/utils/timer.py:10-46): context
managers that, when ``sync`` is on, wait for the work queued on the CUDA
card (``torch.cuda.synchronize``) before reading the clock at entry and
exit, so that a stage is charged its device time. Work on the CPU needs
no wait, and none is made where CUDA was never used.
"""

from __future__ import annotations

import time
from typing import Dict

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class IterTimer:
    def __init__(self, name: str = '', sync: bool = True,
                 enabled: bool = True):
        self.name = name
        self.sync = sync
        self.enabled = enabled
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def __enter__(self):
        if self.enabled:
            if self.sync:
                _sync()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled and self._t0 is not None:
            if self.sync:
                _sync()
            self.total += time.perf_counter() - self._t0
            self.count += 1
        return False

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)

    def __repr__(self):
        return f'IterTimer({self.name}: avg {self.avg * 1e3:.2f} ms over ' \
               f'{self.count})'


class IterTimers:
    """Named timer registry (the reference's ``default_timers``)."""

    def __init__(self, enabled: bool = False, sync: bool = True):
        self.enabled = enabled
        self.sync = sync
        self.timers: Dict[str, IterTimer] = {}

    def __call__(self, name: str) -> IterTimer:
        if name not in self.timers:
            self.timers[name] = IterTimer(name, sync=self.sync,
                                          enabled=self.enabled)
        t = self.timers[name]
        t.enabled = self.enabled
        return t

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def summary(self) -> str:
        return '; '.join(
            f'{n}: {t.avg * 1e3:.2f} ms' for n, t in self.timers.items())

