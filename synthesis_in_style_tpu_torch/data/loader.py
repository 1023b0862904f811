"""The endless batch stream the trainer reads (counterpart of `EpochStream`
in synthesis_in_style_tpu/data/loader.py), over a torch DataLoader, with the
fractional epoch the `(N, "epoch")` triggers need."""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
from torch.utils.data import DataLoader, Sampler


class EpochStream:
    """Endless batch stream over a DataLoader (one loader iterator, and so
    one set of worker processes, per epoch); `key` selects one entry of each
    batch dict. `close()` ends the current epoch's workers."""

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
        # dropping the epoch's iterator shuts its worker processes down
        self._iterator = None


class EpochShuffleSampler(Sampler):
    """The JAX DataLoader's order: epoch e visits
    `numpy.random.default_rng((seed, e)).permutation(n)` (or 0..n-1 without
    shuffle). Each pass advances the epoch; `seek` positions the next pass
    `skip` samples into an epoch (preemption resume)."""

    def __init__(self, n: int, seed: int = 0, shuffle: bool = True):
        self.n = n
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0
        self._skip = 0

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(self.n)
        else:
            order = np.arange(self.n)
        skip, self._skip = self._skip, 0
        self.epoch += 1
        return iter(order[skip:].tolist())

    def seek(self, epoch: int, skip: int) -> None:
        self.epoch, self._skip = epoch, skip


def make_loader(dataset, batch_size: int, shuffle: bool, drop_last: bool, num_workers: int,
                seed: int = 0, pin_memory: bool = False) -> DataLoader:
    """A torch DataLoader in the JAX DataLoader's sample order (shuffled
    per epoch from `seed`, or in order) with its `drop_last`. Validation
    loaders are unsharded: the port trains in one process."""
    return DataLoader(dataset, batch_size=batch_size, drop_last=drop_last,
                      sampler=EpochShuffleSampler(len(dataset), seed, shuffle),
                      num_workers=num_workers, pin_memory=pin_memory,
                      persistent_workers=False)
