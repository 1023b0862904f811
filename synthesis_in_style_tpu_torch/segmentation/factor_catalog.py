"""Per-layer k-means catalogs in the JAX package's npz format (counterpart
of synthesis_in_style_tpu/segmentation/factor_catalog.py): `FactorCatalog`
(fit one layer's spherical k-means, predict nearest centres),
`save_catalogs` / `load_catalogs` (`catalogs/<k>.npz` with `centers_<layer>`
and `counts_<layer>`, and its `.annotations.json`), and
`convert_legacy_catalog`, which re-exports a reference `catalogs/<k>.pkl` of
pickled estimators as npz."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from synthesis_in_style_tpu_torch.segmentation.kmeans import MiniBatchSphericalKMeans
from synthesis_in_style_tpu_torch.segmentation.ptutils import partial_flat


class FactorCatalog:
    """The k-means catalog of one layer: `k` clusters, fitted with the
    JAX package's estimator defaults unless `kmeans_kwargs` say otherwise."""

    def __init__(self, k: int, seed: int = 0, **kmeans_kwargs):
        self.k = k
        self._kmeans = MiniBatchSphericalKMeans(n_clusters=k, seed=seed, **kmeans_kwargs)
        self.annotations: Dict[str, list] = {}

    @property
    def cluster_centers(self) -> Optional[np.ndarray]:
        return self._kmeans.cluster_centers_

    @property
    def n_steps(self) -> int:
        """Minibatch steps of the last fit (or partial fits so far)."""
        return self._kmeans.n_steps_

    def fit_predict(self, x: torch.Tensor) -> torch.Tensor:
        """Fit on (N, H, W, C) activations (on their device); return the
        (N, H, W) nearest-centre labels."""
        self._kmeans.fit(partial_flat(x)[0])
        return self.predict(x)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) activations -> (N, H, W) nearest-centre labels, on
        x's device."""
        labels = self._kmeans.predict(partial_flat(x)[0])
        return labels.reshape(x.shape[0], x.shape[1], x.shape[2])


def _restored(centers: np.ndarray, counts: Optional[np.ndarray] = None,
              annotations: Optional[Dict] = None) -> FactorCatalog:
    catalog = FactorCatalog(k=centers.shape[0])
    catalog._kmeans.cluster_centers_ = centers
    catalog._kmeans._counts = counts
    catalog.annotations = dict(annotations or {})
    return catalog


def load_catalogs(path: Union[str, Path]) -> Dict[str, FactorCatalog]:
    """{layer_id: FactorCatalog} from the `centers_<layer>` (and, where
    written, `counts_<layer>`) arrays of `catalogs/<k>.npz` and its
    `.annotations.json`, where there is one."""
    path = Path(path)
    ann_path = path.with_suffix(".annotations.json")
    annotations = json.loads(ann_path.read_text()) if ann_path.exists() else {}
    catalogs = {}
    with np.load(path) as data:
        for name in data.files:
            if not name.startswith("centers_"):
                continue
            layer_id = name[len("centers_"):]
            counts = data[f"counts_{layer_id}"] if f"counts_{layer_id}" in data.files else None
            catalogs[layer_id] = _restored(data[name], counts, annotations.get(layer_id, {}))
    return catalogs


def save_catalogs(catalogs: Dict[str, FactorCatalog], path: Union[str, Path]) -> None:
    """`{layer_id: FactorCatalog}` to one npz (`centers_<layer>`, and
    `counts_<layer>` where the estimator has counts) and its
    `.annotations.json`, the JAX package's layout."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for layer_id, catalog in catalogs.items():
        if catalog.cluster_centers is None:
            raise ValueError(f"catalog of layer {layer_id} has no centres")
        arrays[f"centers_{layer_id}"] = catalog.cluster_centers
        if catalog._kmeans._counts is not None:
            arrays[f"counts_{layer_id}"] = catalog._kmeans._counts
    np.savez(path, **arrays)
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
        catalogs[str(layer_id)] = _restored(
            np.asarray(est.cluster_centers_),
            annotations=getattr(legacy_catalog, "annotations", {}))
    save_catalogs(catalogs, out_path)
    return catalogs
