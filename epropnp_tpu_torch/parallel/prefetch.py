"""Host-side batch pipelines on threads, and device prefetch: the
counterpart of ``epropnp_tpu/parallel/prefetch.py``.

The reference overlaps data loading with compute through ``DataLoader``
workers and pinned, non-blocking host-to-device copies
(EPro-PnP-6DoF/tools/main.py:82-88, lib/train.py:62-68). Here:

* :class:`PrefetchLoader` maps work items (e.g. the index batches of
  ``sampler.HostShardSampler``) to host batches on ``num_workers``
  threads, at most ``num_workers + prefetch_depth`` items in flight, in
  order, and moves each batch to the device ahead of the consumer.
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
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional

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


class _DeviceStager:
    """Copies batches to ``device`` ahead of their use: :meth:`put` starts
    a batch's copy (pinned, non-blocking, on a side stream for a CUDA
    device), :meth:`take` hands it to the consumer's stream."""

    def __init__(self, device=None):
        self.device = torch.device('cuda' if device is None else device)
        self.cuda = self.device.type == 'cuda'
        self.side = torch.cuda.Stream(self.device) if self.cuda else None

    def put(self, batch):
        arrays = _fields(batch.values() if isinstance(batch, dict)
                         else batch)
        if not self.cuda:
            return batch, [None if a is None else a.to(self.device)
                           for a in arrays], None
        arrays = [a if a is None or a.is_cuda or a.is_pinned()
                  else a.pin_memory() for a in arrays]
        with torch.cuda.stream(self.side):
            moved = [None if a is None else a.to(self.device,
                                                  non_blocking=True)
                     for a in arrays]
            done = self.side.record_event()
        return batch, moved, done

    def take(self, entry):
        batch, moved, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in moved:
                if t is not None:
                    t.record_stream(consumer)
        if isinstance(batch, dict):
            return dict(zip(batch, moved))
        return (type(batch)(*moved) if hasattr(batch, '_fields')
                else type(batch)(moved))


def prefetch_to_device(batches: Iterable[Any], depth: int = 2,
                       device=None) -> Iterator[Any]:
    """Yield the batches of ``batches`` (tuples, named tuples or dicts of
    numpy arrays or tensors, or None for an absent field, in order) with
    every array on ``device`` (the CUDA card unless given), copied ``depth``
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
    stager = _DeviceStager(device)
    ahead = collections.deque()
    for batch in batches:
        ahead.append(stager.put(batch))
        if len(ahead) > depth:
            yield stager.take(ahead.popleft())
    while ahead:
        yield stager.take(ahead.popleft())


class PrefetchLoader:
    """Threaded batch producer and device-prefetch iterator.

    Args:
        make_fn: maps one work item (e.g. an index array of
            ``HostShardSampler.epoch_batches``) to a host batch, a (named)
            tuple or a dict of numpy arrays or tensors. Runs on the worker
            threads, so it must be thread-safe (numpy pipelines are).
        num_workers: producer threads (0: produce on the consumer's
            thread; the batches are still copied ahead).
        prefetch_depth: batches kept on the device ahead of the consumer;
            2 double-buffers the copy against the step.
        device: where the batches go (the CUDA card unless given), by
            :func:`prefetch_to_device`'s pinned side-stream copies. JAX's
            ``sharding`` argument places a global batch over a mesh; here
            each rank's process loads its own rows.
    """

    def __init__(self, make_fn: Callable[[Any], Any], num_workers: int = 2,
                 prefetch_depth: int = 2, device=None):
        if prefetch_depth < 1:
            raise ValueError(f'PrefetchLoader: prefetch_depth '
                             f'{prefetch_depth} < 1')
        self.make_fn = make_fn
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self.device = device

    def __call__(self, work_items: Iterable[Any]) -> Iterator[Any]:
        """The device batches of ``work_items``, made ahead, in order. An
        exception of ``make_fn`` re-raises here at its item's position."""
        stager = _DeviceStager(self.device)
        if self.num_workers == 0:
            yield from prefetch_to_device(
                (self.make_fn(item) for item in work_items),
                self.prefetch_depth, stager.device)
            return
        items = iter(work_items)
        lookahead = self.num_workers + self.prefetch_depth
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()    # futures, in order
            on_device = collections.deque()  # staged batches, in order
            exhausted = False
            while True:
                # top up the workers, at most ``lookahead`` items in flight
                while not exhausted and \
                        len(pending) + len(on_device) < lookahead:
                    try:
                        pending.append(pool.submit(self.make_fn,
                                                   next(items)))
                    except StopIteration:
                        exhausted = True
                # stage the ready batches, up to ``prefetch_depth``
                while (pending and len(on_device) < self.prefetch_depth
                       and (pending[0].done() or not on_device)):
                    on_device.append(stager.put(pending.popleft().result()))
                if not on_device:
                    break
                yield stager.take(on_device.popleft())
