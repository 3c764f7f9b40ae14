"""Colored console + file logger (a copy of ``epropnp_tpu/utils/logging.py``;
the reference uses a tensorpack-style logger,
EPro-PnP-6DoF/lib/utils/fancy_logger.py:21-40)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_COLORS = {'WARNING': '\033[33m', 'ERROR': '\033[31m', 'DEBUG': '\033[36m'}
_RESET = '\033[0m'


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and sys.stderr.isatty():
            return f'{color}{msg}{_RESET}'
        return msg


def get_logger(name: str = 'epropnp_tpu_torch',
               log_dir: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = '[%(asctime)s %(levelname)s] %(message)s'
    sh = logging.StreamHandler()
    sh.setFormatter(_ColorFormatter(fmt, datefmt='%m%d %H:%M:%S'))
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, 'log.txt'))
        fh.setFormatter(logging.Formatter(fmt, datefmt='%m%d %H:%M:%S'))
        logger.addHandler(fh)
    logger.propagate = False
    return logger
