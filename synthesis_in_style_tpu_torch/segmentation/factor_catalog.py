"""Per-layer k-means catalogs, read from the JAX package's npz format
(counterpart of synthesis_in_style_tpu/segmentation/factor_catalog.py:
`load_catalogs` and `FactorCatalog.predict`). Reference pickle catalogs are
not ported yet (ROADMAP.md)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from synthesis_in_style_tpu_torch.segmentation.kmeans import assign_euclidean


class FactorCatalog:
    """Cluster centres of one layer."""

    def __init__(self, cluster_centers: np.ndarray):
        self.cluster_centers = np.asarray(cluster_centers)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) activations -> (N, H, W) nearest-centre labels."""
        centers = torch.as_tensor(self.cluster_centers, device=x.device, dtype=x.dtype)
        labels = assign_euclidean(x.reshape(-1, x.shape[-1]), centers)
        return labels.reshape(x.shape[0], x.shape[1], x.shape[2])


def load_catalogs(path: Union[str, Path]) -> Dict[str, FactorCatalog]:
    """{layer_id: FactorCatalog} from the `centers_<layer>` arrays of
    `catalogs/<k>.npz`."""
    with np.load(Path(path)) as data:
        return {
            name[len("centers_"):]: FactorCatalog(data[name])
            for name in data.files
            if name.startswith("centers_")
        }
