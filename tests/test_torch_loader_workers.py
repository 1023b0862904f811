"""`data/loader.make_loader` keeps its worker processes for the whole run:
over 3 epochs of an `EpochStream` every worker pid is seen in every epoch,
the order is the JAX `DataLoader`'s (per-epoch permutations from the seed,
drop_last), `seek` resumes mid-epoch in it, `close()` ends the workers, and
a validation loader read pass after pass keeps its workers too."""

import os

import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.data.loader import DataLoader as JaxDataLoader
from synthesis_in_style_tpu_torch.data.loader import EpochStream, make_loader, shutdown_workers

N, BATCH, WORKERS, SEED = 11, 3, 2, 7


class Numbers(torch.utils.data.Dataset):
    def __len__(self):
        return N

    def __getitem__(self, index):
        return {"index": index, "pid": os.getpid()}


class JaxNumbers:
    def __len__(self):
        return N

    def __getitem__(self, index):
        return {"index": np.int64(index)}


def _jax_epochs(epochs, shuffle=True, drop_last=True):
    loader = JaxDataLoader(JaxNumbers(), BATCH, shuffle=shuffle, drop_last=drop_last,
                           num_workers=2, seed=SEED, shard_id=0, num_shards=1)
    out = []
    for _ in range(epochs):
        out.append([int(i) for batch in loader for i in batch["index"]])
    return out


def _read_epoch(stream, loader):
    indices, pids = [], set()
    for _ in range(len(loader)):
        batch = next(stream)
        indices += batch["index"].tolist()
        pids |= set(batch["pid"].tolist())
    return indices, pids


def test_workers_live_across_epochs_in_jax_order():
    loader = make_loader(Numbers(), BATCH, shuffle=True, drop_last=True, num_workers=WORKERS,
                         seed=SEED)
    assert loader.persistent_workers
    stream = EpochStream(loader)
    try:
        epochs = [_read_epoch(stream, loader) for _ in range(3)]
        workers = {pid for _, pids in epochs for pid in pids}
        assert len(workers) == WORKERS and os.getpid() not in workers
        for _, pids in epochs:
            assert pids == workers  # the same processes in every epoch
        assert [indices for indices, _ in epochs] == _jax_epochs(3)
        assert stream.epoch == 3.0
        processes = loader._iterator._workers
        assert all(p.is_alive() for p in processes)
    finally:
        stream.close()
    for p in processes:
        p.join(timeout=10)
    assert not any(p.is_alive() for p in processes)
    assert loader._iterator is None


def test_seek_resumes_mid_epoch():
    want = [i for epoch in _jax_epochs(3) for i in epoch]
    loader = make_loader(Numbers(), BATCH, shuffle=True, drop_last=True, num_workers=WORKERS,
                         seed=SEED)
    stream = EpochStream(loader)
    try:
        next(stream)  # the workers are up; seek re-positions them
        stream.seek(4)  # epoch 1, one batch in
        got = [i for _ in range(5) for i in next(stream)["index"].tolist()]
        assert got == want[4 * BATCH: 9 * BATCH]
        assert stream.epoch == 3.0
    finally:
        stream.close()


def test_validation_passes_keep_their_workers():
    loader = make_loader(Numbers(), BATCH, shuffle=False, drop_last=False, num_workers=WORKERS)
    try:
        passes = [[(int(i), int(p)) for batch in loader
                   for i, p in zip(batch["index"], batch["pid"])] for _ in range(3)]
        pids = [{p for _, p in one} for one in passes]
        assert pids[0] == pids[1] == pids[2] and len(pids[0]) == WORKERS
        for one in passes:
            assert [i for i, _ in one] == list(range(N))  # every sample, in order
        assert [i for i, _ in passes[0]] == _jax_epochs(1, shuffle=False, drop_last=False)[0]
    finally:
        shutdown_workers(loader)


@pytest.mark.parametrize("num_workers", [0, 1])
def test_no_workers_and_one_worker(num_workers):
    loader = make_loader(Numbers(), BATCH, shuffle=True, drop_last=True,
                         num_workers=num_workers, seed=SEED)
    assert loader.persistent_workers == (num_workers > 0)
    stream = EpochStream(loader)
    try:
        assert [_read_epoch(stream, loader)[0] for _ in range(2)] == _jax_epochs(2)
    finally:
        stream.close()
