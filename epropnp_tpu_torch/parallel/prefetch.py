"""Host-side batch pipeline on a background thread, and device prefetch:
the single-device part of ``epropnp_tpu/parallel/prefetch.py``.

The reference overlaps data loading with compute through ``DataLoader``
workers and pinned, non-blocking host-to-device copies
(EPro-PnP-6DoF/tools/main.py:82-88, lib/train.py:62-68). Here:

* :class:`BackgroundIterator` advances a batch generator on a daemon
  thread, a bounded number of batches ahead; the numpy work of the 6DoF
  pipeline releases the GIL for most of its time.
* :func:`prefetch_to_device` keeps ``depth`` batches on the device ahead
  of the consumer: on a CUDA device each batch is copied from pinned host
  memory with ``non_blocking=True`` on a side stream, and the consumer's
  stream waits for that copy's event before it receives the batch.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch


class BackgroundIterator:
    """Run any iterator on a daemon thread with a bounded queue.

    The iterator advances on its own thread, up to ``maxsize`` items ahead
    of the consumer, in its own order. An exception it raises re-raises on
    the consumer at its position.
    """

    _END = object()

    def __init__(self, it: Iterable[Any], maxsize: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(iter(it),), daemon=True)
        self._thread.start()

    def _run(self, it):
        try:
            for x in it:
                self._q.put(x)
        except BaseException as e:  # noqa: BLE001 - re-raised on consumer
            self._err = e
        finally:
            self._q.put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return x


def _fields(batch):
    """A batch's arrays, as tensors (numpy arrays become CPU tensors); an
    absent field (None) stays None."""
    return [a if a is None or isinstance(a, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(a)) for a in batch]


def prefetch_to_device(batches: Iterable[Any], depth: int = 2,
                       device=None) -> Iterator[Any]:
    """Yield the batches of ``batches`` (tuples or named tuples of numpy
    arrays or tensors, or None for an absent field, in order) with every
    array on ``device`` (the CUDA card unless given), copied ``depth``
    batches ahead of the consumer.

    On a CUDA device the host arrays are pinned and copied with
    ``non_blocking=True`` on a side stream; before a batch is yielded the
    consumer's current stream waits for its copy, and each of its tensors
    is recorded on that stream, so the caching allocator does not hand its
    memory to another tensor while the consumer's work may still read it.
    On another device the arrays are copied with ``Tensor.to``.
    """
    if depth < 1:
        raise ValueError(f'prefetch_to_device: depth {depth} < 1')
    device = torch.device('cuda' if device is None else device)
    cuda = device.type == 'cuda'
    side = torch.cuda.Stream(device) if cuda else None

    def put(batch):
        arrays = _fields(batch)
        if not cuda:
            return batch, [None if a is None else a.to(device)
                           for a in arrays], None
        arrays = [a if a is None or a.is_cuda or a.is_pinned()
                  else a.pin_memory() for a in arrays]
        with torch.cuda.stream(side):
            moved = [None if a is None else a.to(device, non_blocking=True)
                     for a in arrays]
            done = side.record_event()
        return batch, moved, done

    def take(entry):
        batch, moved, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in moved:
                if t is not None:
                    t.record_stream(consumer)
        return (type(batch)(*moved) if hasattr(batch, '_fields')
                else type(batch)(moved))

    ahead = collections.deque()
    for batch in batches:
        ahead.append(put(batch))
        if len(ahead) > depth:
            yield take(ahead.popleft())
    while ahead:
        yield take(ahead.popleft())
