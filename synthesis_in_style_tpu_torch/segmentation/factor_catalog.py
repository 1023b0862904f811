"""Per-layer k-means catalogs in the JAX package's npz format (counterpart
of synthesis_in_style_tpu/segmentation/factor_catalog.py: `load_catalogs`,
`save_catalogs`, `FactorCatalog.predict`, and `convert_legacy_catalog`,
which re-exports a reference `catalogs/<k>.pkl` of pickled estimators as
npz)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from synthesis_in_style_tpu_torch.segmentation.kmeans import assign_euclidean


class FactorCatalog:
    """Cluster centres of one layer."""

    def __init__(self, cluster_centers: np.ndarray, annotations: Dict = None):
        self.cluster_centers = np.asarray(cluster_centers)
        self.annotations = dict(annotations or {})

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) activations -> (N, H, W) nearest-centre labels."""
        centers = torch.as_tensor(self.cluster_centers, device=x.device, dtype=x.dtype)
        labels = assign_euclidean(x.reshape(-1, x.shape[-1]), centers)
        return labels.reshape(x.shape[0], x.shape[1], x.shape[2])


def load_catalogs(path: Union[str, Path]) -> Dict[str, FactorCatalog]:
    """{layer_id: FactorCatalog} from the `centers_<layer>` arrays of
    `catalogs/<k>.npz` (and its `.annotations.json`, where there is one)."""
    path = Path(path)
    ann_path = path.with_suffix(".annotations.json")
    annotations = json.loads(ann_path.read_text()) if ann_path.exists() else {}
    with np.load(path) as data:
        return {
            name[len("centers_"):]: FactorCatalog(
                data[name], annotations.get(name[len("centers_"):], {}))
            for name in data.files
            if name.startswith("centers_")
        }


def save_catalogs(catalogs: Dict[str, FactorCatalog], path: Union[str, Path]) -> None:
    """`{layer_id: FactorCatalog}` to one npz (`centers_<layer>`) and its
    `.annotations.json`, the JAX package's layout."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{f"centers_{layer_id}": catalog.cluster_centers
                      for layer_id, catalog in catalogs.items()})
    with open(path.with_suffix(".annotations.json"), "w") as f:
        json.dump({layer_id: catalog.annotations for layer_id, catalog in catalogs.items()}, f)


def load_legacy_pickle(pkl_path: Union[str, Path]) -> Dict:
    """Unpickle a reference `catalogs/<k>.pkl` under stand-in modules for the
    module paths reference pickles carry (`gan_local_edit.*` and
    `segmentation.gan_local_edit.*`): the estimators come back as plain
    objects holding their attributes (`cluster_centers_`, `annotations`,
    `_factorization`). Returns the raw {layer_id: catalog} dict (plus
    `id_to_size_map` if present)."""
    import pickle
    import sys
    import types

    modules = {}
    for root in ("gan_local_edit", "segmentation.gan_local_edit"):
        for leaf in ("", ".spherical_kmeans", ".factor_catalog", ".ptutils"):
            parts = (root + leaf).split(".")
            for d in range(1, len(parts) + 1):
                name = ".".join(parts[:d])
                if name not in modules and name not in sys.modules:
                    modules[name] = types.ModuleType(name)

    class _LegacyKMeans:
        pass

    class _LegacyCatalog:
        pass

    class _LegacyStore:
        pass

    for name, mod in modules.items():
        if name.endswith("spherical_kmeans"):
            mod.MiniBatchSphericalKMeans = _LegacyKMeans
        elif name.endswith("factor_catalog"):
            mod.FactorCatalog = _LegacyCatalog
        elif name.endswith("ptutils"):
            mod.MultiResolutionStore = _LegacyStore
        sys.modules.setdefault(name, mod)
    for name in list(modules):
        if "." in name:
            parent, leaf = name.rsplit(".", 1)
            setattr(sys.modules[parent], leaf, sys.modules[name])

    with open(pkl_path, "rb") as f:
        return pickle.load(f)


def convert_legacy_catalog(pkl_path: Union[str, Path], out_path: Union[str, Path]
                           ) -> Dict[str, FactorCatalog]:
    """Convert a reference `catalogs/<k>.pkl` to the npz format at
    `out_path`; returns the catalogs."""
    legacy = load_legacy_pickle(pkl_path)
    legacy.pop("id_to_size_map", None)
    catalogs = {}
    for layer_id, legacy_catalog in legacy.items():
        est = getattr(legacy_catalog, "_factorization", legacy_catalog)
        catalogs[str(layer_id)] = FactorCatalog(
            np.asarray(est.cluster_centers_), getattr(legacy_catalog, "annotations", {}))
    save_catalogs(catalogs, out_path)
    return catalogs
