"""The endless batch stream the trainer reads (counterpart of `EpochStream`
in synthesis_in_style_tpu/data/loader.py), over a torch DataLoader, with the
fractional epoch the `(N, "epoch")` triggers need.

`make_loader` keeps its worker processes for the whole run
(`persistent_workers`): an epoch or a validation pass starts none, as the
JAX package's thread-pool loader starts none. The sampler is still iterated
in this process at every pass, so the order and `seek` are unchanged; the
datasets keep no state that changes between epochs (workers would not see
it). `shutdown_workers` ends them."""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
from torch.utils.data import DataLoader, Sampler

from synthesis_in_style_tpu_torch.parallel import distributed


def shutdown_workers(loader: DataLoader) -> None:
    """End a loader's kept worker processes (a no-op without workers); the
    next pass starts new ones."""
    iterator = getattr(loader, "_iterator", None)
    if iterator is not None:
        loader._iterator = None
        shutdown = getattr(iterator, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()


class EpochStream:
    """Endless batch stream over a DataLoader (a pass per epoch; with
    `make_loader`'s persistent workers, one set of worker processes for all
    of them); `key` selects one entry of each batch dict. `close()` ends the
    workers."""

    def __init__(self, loader: DataLoader, key: Optional[str] = None):
        self._loader = loader
        self._key = key
        self._iterator: Optional[Iterator[Any]] = None
        self._epochs_done = 0
        self._batches_into_epoch = 0

    def __iter__(self) -> "EpochStream":
        return self

    def __next__(self):
        while True:
            if self._iterator is None:
                self._iterator = iter(self._loader)
            try:
                batch = next(self._iterator)
                break
            except StopIteration:
                self._iterator = None
                self._epochs_done += 1
                self._batches_into_epoch = 0
        self._batches_into_epoch += 1
        return batch[self._key] if self._key is not None else batch

    @property
    def epoch(self) -> float:
        return self._epochs_done + self._batches_into_epoch / max(1, len(self._loader))

    def seek(self, iteration: int) -> None:
        """Position the stream as if `iteration` batches had been read (the
        loader's sampler must be an EpochShuffleSampler; drop_last batches)."""
        per_epoch = max(1, len(self._loader))
        epoch, into = divmod(iteration, per_epoch)
        self._loader.sampler.seek(epoch, into * self._loader.batch_size)
        self._iterator = None
        self._epochs_done, self._batches_into_epoch = epoch, into

    def close(self) -> None:
        self._iterator = None
        shutdown_workers(self._loader)


class EpochShuffleSampler(Sampler):
    """The JAX DataLoader's order: epoch e visits
    `numpy.random.default_rng((seed, e)).permutation(n)` (or 0..n-1 without
    shuffle). Each pass advances the epoch; `seek` positions the next pass
    `skip` samples into an epoch (preemption resume).

    Shard `shard_id` of `num_shards` (a process of a launched run) visits
    every num_shards-th sample of that order from its own offset, the order
    first padded with its own head so that every shard has as many samples
    (the JAX loader's rule, torch's DistributedSampler's too)."""

    def __init__(self, n: int, seed: int = 0, shuffle: bool = True, shard_id: int = 0,
                 num_shards: int = 1):
        self.n = n
        self.seed = seed
        self.shuffle = shuffle
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0
        self._skip = 0

    def __len__(self) -> int:
        return -(-self.n // self.num_shards)

    def __iter__(self):
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(self.n)
        else:
            order = np.arange(self.n)
        total = len(self) * self.num_shards
        if total > self.n:
            order = np.concatenate([order, order[: total - self.n]])
        order = order[self.shard_id:: self.num_shards]
        skip, self._skip = self._skip, 0
        self.epoch += 1
        return iter(order[skip:].tolist())

    def seek(self, epoch: int, skip: int) -> None:
        self.epoch, self._skip = epoch, skip


def make_loader(dataset, batch_size: int, shuffle: bool, drop_last: bool, num_workers: int,
                seed: int = 0, pin_memory: bool = False, sharded: bool = False) -> DataLoader:
    """A torch DataLoader in the JAX DataLoader's sample order (shuffled
    per epoch from `seed`, or in order) with its `drop_last`, whose worker
    processes (if any) live until `shutdown_workers` or the loader's end.
    `sharded` (a training loader): in a launched multi-process run, this
    process's shard (its rank of the world size, parallel/distributed.py),
    `batch_size` rows of it a batch; validation and evaluation loaders are
    whole."""
    shard_id, num_shards = ((distributed.get_rank(), distributed.get_world_size())
                            if sharded else (0, 1))
    return DataLoader(dataset, batch_size=batch_size, drop_last=drop_last,
                      sampler=EpochShuffleSampler(len(dataset), seed, shuffle, shard_id,
                                                  num_shards),
                      num_workers=num_workers, pin_memory=pin_memory,
                      persistent_workers=num_workers > 0)
