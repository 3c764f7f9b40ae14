"""Per-rank sharded sampling for data-parallel training, a copy of
``epropnp_tpu/parallel/sampler.py`` (``HostShardSampler``) in numpy.

The reference feeds each DDP rank a disjoint slice of the dataset through
``torch.utils.data.DistributedSampler``. The semantics are that
sampler's with ``shuffle=True``:

* one permutation per epoch, the same on every rank, seeded by
  ``seed + epoch`` only;
* the permutation padded by wrapping around (``drop_last=False``) or cut
  (``drop_last=True``) to a multiple of the number of ranks, so every
  rank yields the same number of samples (a rank that runs short would
  stall the collectives);
* strided slices, ``indices[rank::num_ranks]``.

Composes with ``det.main.CBGSWrapper``: pass its resampled index list as
``indices``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np


def _group():
    """``(world size, rank)`` of the ``torch.distributed`` group, or (1, 0)
    when none is up."""
    from . import mesh
    return mesh.world_size(), mesh.rank()


class HostShardSampler:
    """Deterministic per-rank epoch sampler (``DistributedSampler``'s
    semantics).

    Args:
        num_samples: the dataset's length (ignored if ``indices`` is
            given).
        indices: explicit sample indices (e.g. from CBGS resampling);
            ``arange(num_samples)`` by default.
        num_hosts / host_id: the number of ranks and this one's;
            ``torch.distributed``'s world size and rank by default, or 1
            and 0 when no group is up.
        shuffle: a new order each epoch (the same on every rank).
        seed: base seed; epoch ``e`` uses ``seed + e``.
        drop_last: cut the tail so every rank has as many samples (True),
            or pad by wrapping to the next multiple (False, torch's
            default).
    """

    def __init__(self, num_samples: Optional[int] = None,
                 indices: Optional[Sequence[int]] = None,
                 num_hosts: Optional[int] = None,
                 host_id: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        if indices is None:
            assert num_samples is not None
            indices = np.arange(num_samples)
        self.indices = np.asarray(indices, np.int64)
        if num_hosts is None or host_id is None:
            world, rank = _group()
            num_hosts = world if num_hosts is None else num_hosts
            host_id = rank if host_id is None else host_id
        self.num_hosts, self.host_id = num_hosts, host_id
        assert 0 <= self.host_id < self.num_hosts
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        n = len(self.indices)
        if drop_last:
            self.num_per_host = n // self.num_hosts
        else:
            self.num_per_host = -(-n // self.num_hosts)  # ceil

    def __len__(self) -> int:
        return self.num_per_host

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This rank's sample indices for ``epoch`` (``len(self)`` of
        them)."""
        order = self.indices
        if self.shuffle:
            order = order[np.random.default_rng(
                self.seed + epoch).permutation(len(order))]
        total = self.num_per_host * self.num_hosts
        if total > len(order):  # pad by wrapping (torch's semantics)
            order = np.concatenate([order, order[:total - len(order)]])
        else:
            order = order[:total]
        return order[self.host_id::self.num_hosts]

    def epoch_batches(self, epoch: int, batch_size_per_host: int,
                      drop_partial: bool = True) -> Iterator[np.ndarray]:
        """This rank's index batches of ``batch_size_per_host``."""
        inds = self.epoch_indices(epoch)
        n_full = len(inds) // batch_size_per_host
        for i in range(n_full):
            yield inds[i * batch_size_per_host:(i + 1) * batch_size_per_host]
        if not drop_partial and n_full * batch_size_per_host < len(inds):
            yield inds[n_full * batch_size_per_host:]
