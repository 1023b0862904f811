"""Worker processes for the host contour half (counterpart of
synthesis_in_style_tpu/segmentation/contour_pool.py, `--contour-workers`).

The contour half of labelled-dataset synthesis is per-image CPU work that
holds the GIL (the tracer is numpy and Python), so it scales over
processes, not threads. Each worker rebuilds a host-half-only segmenter from
the picklable spec of `BaseClusterBasedDatasetSegmenter.contour_spec` (no
catalog, no device state, no CUDA) and runs `segment_prepared` on shards of
a batch. Workers are spawned, never forked: the parent holds a CUDA context.
"""

from __future__ import annotations

import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

_WORKER_SEGMENTER = None


def _init_worker(spec: Dict) -> None:
    global _WORKER_SEGMENTER
    from synthesis_in_style_tpu_torch.segmentation.dataset_segmenter import (
        BaseClusterBasedDatasetSegmenter,
    )

    _WORKER_SEGMENTER = BaseClusterBasedDatasetSegmenter.from_contour_spec(spec)


def _run_shard(payload: Tuple[Dict, int]) -> Tuple[np.ndarray, List[int]]:
    predicted_slice, shard_size = payload
    return _WORKER_SEGMENTER.segment_prepared(predicted_slice, shard_size)


class ContourWorkerPool:
    """`pool.segment_prepared(predicted, B)` returns what
    `segmenter.segment_prepared(predicted, B)` returns: colour masks for the
    whole batch and the ids of the images to drop (shard-local ids mapped
    back to batch indices)."""

    def __init__(self, segmenter, num_workers: int, shard_size: int = 2):
        self.shard_size = max(1, shard_size)
        self._executor = ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_init_worker,
            initargs=(segmenter.contour_spec(),),
        )

    def segment_prepared(self, predicted: Dict[str, Dict[str, np.ndarray]], batch_size: int
                         ) -> Tuple[np.ndarray, List[int]]:
        shards = []
        for start in range(0, batch_size, self.shard_size):
            end = min(start + self.shard_size, batch_size)
            predicted_slice = {
                layer: {cls: np.asarray(arr[start:end]) for cls, arr in classes.items()}
                for layer, classes in predicted.items()
            }
            shards.append((start, self._executor.submit(_run_shard,
                                                        (predicted_slice, end - start))))
        images = []
        drop_ids: List[int] = []
        for start, future in shards:
            shard_images, shard_drops = future.result()
            images.append(shard_images)
            drop_ids.extend(start + d for d in shard_drops)
        return np.concatenate(images, axis=0), drop_ids

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "ContourWorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
