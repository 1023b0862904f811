"""The endless batch stream the trainer reads (counterpart of `EpochStream`
in synthesis_in_style_tpu/data/loader.py), over a torch DataLoader, with the
fractional epoch the `(N, "epoch")` triggers need."""

from __future__ import annotations

from typing import Any, Iterator, Optional

from torch.utils.data import DataLoader


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

    def close(self) -> None:
        # dropping the epoch's iterator shuts its worker processes down
        self._iterator = None
