"""The host contour route of labelled-dataset synthesis, port against the
JAX package on the CPU:

(a) `segment_prepared` on the JAX tests' fixtures (rectangles, 1-px
    speckle, random blobs), with `only_keep_overlapping` both ways,
    `clip_to_class_regions`, `fine_mask_dilation` and `keys_to_merge`:
    identical colour masks and drop lists;
(b) `ContourWorkerPool` (2 spawned workers) equal to the in-process route;
(c) the two dataset CLIs end to end without --device-contours, on converted
    weights and the same z: pixel-identical label PNGs (image halves within 1
    of 255, float32 rounding of two generators), equal train.json,
    val.json and coco_gt.json (but for its capture times), and the port with
    --contour-workers 2 equal to the port in process;
(d) the port's OpenCV-free `has_<class>` rule against `extract_rles`, and
    the port's COCO RLEs against the JAX ones;
(e) reference pickle catalogs converted as the JAX package converts them,
    and read by the port's dataset segmenter.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_contour_pool import CLASSES, COARSE, FINE, _synthetic_predicted  # noqa: E402
from test_torch_dataset_segmentation import (  # noqa: E402
    BATCH,
    STYLE_DIM,
    _cli_run,
    _generators,
)

from synthesis_in_style_tpu.cli import create_dataset_for_segmentation as jax_cds  # noqa: E402
from synthesis_in_style_tpu.evaluation import coco_gt as jax_coco  # noqa: E402
from synthesis_in_style_tpu.segmentation.dataset_segmenter import (  # noqa: E402
    BaseClusterBasedDatasetSegmenter as JaxBase,
    BlackWhiteHandwrittenPrintedTextDatasetSegmenter as JaxSegmenter,
)
from synthesis_in_style_tpu.utils.segmentation_utils import (  # noqa: E402
    resolve_color_map as jax_resolve_color_map,
)
from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds  # noqa: E402
from synthesis_in_style_tpu_torch.evaluation import coco_gt  # noqa: E402
from synthesis_in_style_tpu_torch.segmentation.contour_pool import ContourWorkerPool  # noqa: E402
from synthesis_in_style_tpu_torch.segmentation.dataset_segmenter import (  # noqa: E402
    BaseClusterBasedDatasetSegmenter,
    BlackWhiteHandwrittenPrintedTextDatasetSegmenter,
)
from synthesis_in_style_tpu_torch.utils.png import read_png  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401

COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}


def _spec(cls, size, only_keep_overlapping=False, clip=False, dilation=0, min_area=2,
          merged=False):
    """A host-half-only segmenter's spec; with `merged`, the class regions
    come from one virtual layer, the OR of the two coarse layers."""
    color_map = jax_resolve_color_map(COLORS)
    coarse, keys_to_merge = (["merged"], {"merged": COARSE}) if merged else (COARSE, {})
    return {"cls": cls, "attrs": {
        "base_dir": Path("."), "image_size": size, "class_to_color_map": color_map,
        "class_id_map": {n: i for i, n in enumerate(color_map)}, "debug": False,
        "debug_images": {}, "keys_for_class_determination": coarse,
        "keys_for_finegrained_segmentation": FINE, "keys_for_generation": set(COARSE + FINE),
        "keys_to_merge": keys_to_merge, "num_clusters": 3, "min_class_contour_area": min_area,
        "only_keep_overlapping": only_keep_overlapping,
        "handwriting_overlap_threshold": 0.5, "clip_to_class_regions": clip,
        "fine_mask_dilation": dilation}}


def _pair(size, **kw):
    jseg = JaxBase.from_contour_spec(_spec(JaxSegmenter, size, **kw))
    tseg = BaseClusterBasedDatasetSegmenter.from_contour_spec(
        _spec(BlackWhiteHandwrittenPrintedTextDatasetSegmenter, size, **kw))
    return jseg, tseg


def _speckle(batch, size, seed, density):
    rng = np.random.default_rng(seed)
    return {layer: {cls: (np.zeros((batch, size, size), bool) if cls == "background"
                          else rng.random((batch, size, size)) < density)
                    for cls in CLASSES} for layer in COARSE + FINE}


def _blobs(batch, size, seed):
    """Smoothed noise thresholded per layer: overlapping irregular regions
    with holes, as cluster masks look."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    out = {}
    for layer in COARSE + FINE:
        per_class = {}
        for cls in CLASSES:
            noise = ndimage.gaussian_filter(rng.random((batch, size, size)), (0, 2, 2))
            per_class[cls] = noise > np.quantile(noise, 0.6)
        out[layer] = per_class
    return out


FIXTURES = {
    "rectangles": lambda: _synthetic_predicted(batch=6, size=32, seed=0),
    "speckle": lambda: _speckle(4, 32, 42, 0.04),
    "dense_speckle": lambda: _speckle(3, 32, 7, 0.3),
    "blobs": lambda: _blobs(4, 48, 3),
}


def _copy(predicted):
    return {k: {c: v.copy() for c, v in d.items()} for k, d in predicted.items()}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
@pytest.mark.parametrize("options", [
    {"only_keep_overlapping": False}, {"only_keep_overlapping": True},
    {"clip": True}, {"dilation": 2}, {"only_keep_overlapping": True, "clip": True,
                                      "dilation": 1, "min_area": 20},
    {"merged": True, "clip": True},
], ids=["keep_all", "only_overlapping", "clip", "dilation", "all_options", "merged_layers"])
def test_segment_prepared_matches_jax(fixture, options):
    predicted = FIXTURES[fixture]()
    batch, size = predicted[FINE[0]]["printed_text"].shape[:2]
    jseg, tseg = _pair(size, **options)
    j_images, j_drops = jseg.segment_prepared(_copy(predicted), batch)
    t_images, t_drops = tseg.segment_prepared(_copy(predicted), batch)
    np.testing.assert_array_equal(t_images, j_images)
    assert t_drops == j_drops


def test_segment_prepared_drops_full_extent_images():
    predicted = _synthetic_predicted(batch=6, size=32, seed=0)
    for layer in COARSE + FINE:
        predicted[layer]["printed_text"][5] = True
    jseg, tseg = _pair(32)
    j_images, j_drops = jseg.segment_prepared(_copy(predicted), 6)
    t_images, t_drops = tseg.segment_prepared(_copy(predicted), 6)
    assert 5 in j_drops and t_drops == j_drops
    np.testing.assert_array_equal(t_images, j_images)


def test_contour_pool_matches_in_process():
    predicted = _speckle(6, 32, 5, 0.08)
    for layer in COARSE + FINE:  # image 3 spans the page: dropped, in the second shard
        predicted[layer]["printed_text"][3] = True
    _, tseg = _pair(32)
    expected, expected_drops = tseg.segment_prepared(_copy(predicted), 6)
    assert 3 in expected_drops
    with ContourWorkerPool(tseg, num_workers=2, shard_size=2) as pool:
        got, got_drops = pool.segment_prepared(_copy(predicted), 6)
    np.testing.assert_array_equal(got, expected)
    assert sorted(got_drops) == sorted(expected_drops)


# ---------------------------------------------------------------------------
# the two CLIs end to end


def _z_stream(seed=3):
    rs = np.random.RandomState(seed)
    while True:
        yield rs.randn(BATCH, STYLE_DIM).astype(np.float32)


def _run_jax_cli(monkeypatch, argv):
    import jax.numpy as jnp

    jgen, variables, _ = _generators()
    stream = _z_stream()
    monkeypatch.setattr(jax_cds, "load_generator", lambda *a, **k: (jgen, variables))
    monkeypatch.setattr(jax_cds, "build_latent_and_noise_generator",
                        lambda *a, **k: (jnp.asarray(z) for z in stream))
    jax_cds.main(jax_cds.build_parser().parse_args(argv))


def _run_port_cli(monkeypatch, argv):
    stream = _z_stream()
    monkeypatch.setattr(cds, "build_latent_and_noise_generator",
                        lambda *a, **k: (torch.from_numpy(z) for z in stream))
    cds.main(cds.build_parser().parse_args(argv))


def _outputs(image_dir: Path):
    pngs = {str(p.relative_to(image_dir)): read_png(p) for p in sorted(image_dir.glob("**/*.png"))}
    jsons = {name: json.loads((image_dir / name).read_text())
             for name in ("train.json", "val.json", "coco_gt.json")}
    for image in jsons["coco_gt.json"]["images"]:
        image.pop("date_captured")
    return pngs, jsons


def test_cli_host_route_matches_jax(tmp_path, monkeypatch):
    run_dir, argv = _cli_run(tmp_path)
    common = argv[:-2] + ["-n", "12"]  # drop "-d cpu": the JAX CLI takes -d as a no-op
    _run_jax_cli(monkeypatch, common + ["-s", str(tmp_path / "jax")])
    _run_port_cli(monkeypatch, common + ["-d", "cpu", "-s", str(tmp_path / "port")])
    _run_port_cli(monkeypatch, common + ["-d", "cpu", "--contour-workers", "2",
                                         "-s", str(tmp_path / "workers")])
    j_pngs, j_json = _outputs(tmp_path / "jax")
    t_pngs, t_json = _outputs(tmp_path / "port")
    w_pngs, w_json = _outputs(tmp_path / "workers")
    assert len(j_pngs) >= 12 and list(t_pngs) == list(j_pngs)
    painted = 0
    for name, pair in j_pngs.items():
        half = pair.shape[1] // 2
        # labels pixel-identical; the images come from two generators whose
        # float32 outputs round to uint8 at most 1 apart
        np.testing.assert_array_equal(t_pngs[name][:, half:], pair[:, half:], err_msg=name)
        diff = np.abs(t_pngs[name][:, :half].astype(int) - pair[:, :half])
        assert diff.max() <= 1, name
        np.testing.assert_array_equal(w_pngs[name], t_pngs[name], err_msg=name)
        painted += int(pair[:, half:].any())
    assert painted > 0
    assert t_json == j_json and w_json == j_json
    assert j_json["coco_gt.json"]["annotations"]  # the comparison held annotations


# ---------------------------------------------------------------------------
# COCO ground truth


def _masks():
    rng = np.random.default_rng(0)
    masks = [rng.random((20, 24)) < d for d in (0.01, 0.05, 0.1, 0.3, 0.6) for _ in range(8)]
    ring = np.zeros((12, 12), bool)
    ring[1:11, 1:11] = True
    ring[3:9, 3:9] = False
    ring[5, 5] = True
    return masks + [ring, np.zeros((5, 5), bool), np.ones((6, 7), bool)]


def test_extract_rles_matches_jax():
    for mask in _masks():
        m = mask.astype(np.uint8)
        assert coco_gt.COCOGtCreator.extract_rles(m) == jax_coco.COCOGtCreator.extract_rles(m)
        rle = coco_gt.rle_encode(m)
        assert rle == jax_coco.rle_encode(m)
        np.testing.assert_array_equal(coco_gt.rle_decode(rle), m)
        assert coco_gt.rle_area(rle) == int(m.sum())
        assert coco_gt.rle_to_bbox(rle) == jax_coco.rle_to_bbox(rle)


def test_has_class_rule_matches_extract_rles():
    """The port's has_<class> rule == a class mask with an RLE of
    extract_rles (a contour of >= 3 points)."""
    for mask in _masks():
        ref = len(coco_gt.COCOGtCreator.extract_rles(mask.astype(np.uint8))) > 0
        assert coco_gt.has_contour_of_three_points(mask) == ref


# ---------------------------------------------------------------------------
# reference pickle catalogs


def _write_legacy_pickle(path, layers, k=3):
    """A reference-era `catalogs/<k>.pkl`: estimators whose classes claim the
    reference module paths, pickled under stand-in modules."""
    import pickle
    import types

    names = ["segmentation", "segmentation.gan_local_edit",
             "segmentation.gan_local_edit.factor_catalog",
             "segmentation.gan_local_edit.spherical_kmeans"]
    saved = {name: sys.modules.get(name) for name in names}
    mods = {name: types.ModuleType(name) for name in names}

    class FactorCatalog:
        pass

    class MiniBatchSphericalKMeans:
        pass

    for cls, mod in ((FactorCatalog, names[2]), (MiniBatchSphericalKMeans, names[3])):
        cls.__module__, cls.__qualname__ = mod, cls.__name__
        setattr(mods[mod], cls.__name__, cls)
    sys.modules.update(mods)
    try:
        rng = np.random.default_rng(1)
        catalogs = {}
        for layer, channels in layers.items():
            est = MiniBatchSphericalKMeans()
            est.cluster_centers_ = rng.normal(size=(k, channels)).astype(np.float32)
            cat = FactorCatalog()
            cat._factorization = est
            cat.annotations = {"0": ["note"]}
            catalogs[layer] = cat
        catalogs["id_to_size_map"] = {0: 8}
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("wb") as f:
            pickle.dump(catalogs, f)
    finally:
        for name, module in saved.items():
            if module is None:
                del sys.modules[name]
            else:
                sys.modules[name] = module


def test_legacy_pickle_catalog_matches_jax(tmp_path):
    from synthesis_in_style_tpu.segmentation import factor_catalog as jax_catalog
    from synthesis_in_style_tpu_torch.segmentation import factor_catalog

    pkl = tmp_path / "catalogs" / "3.pkl"
    _write_legacy_pickle(pkl, {"8": 4, "12": 6})
    ours = factor_catalog.convert_legacy_catalog(pkl, tmp_path / "port.npz")
    ref = jax_catalog.convert_legacy_catalog(pkl, tmp_path / "jax.npz")
    assert list(ours) == list(ref) == ["8", "12"]
    for layer in ref:
        np.testing.assert_array_equal(ours[layer].cluster_centers, ref[layer].cluster_centers)
        assert ours[layer].annotations == ref[layer].annotations
    # each package reads the other's npz
    for layer, catalog in jax_catalog.load_catalogs(tmp_path / "port.npz").items():
        np.testing.assert_array_equal(catalog.cluster_centers, ref[layer].cluster_centers)
        assert catalog.annotations == ref[layer].annotations
    for layer, catalog in factor_catalog.load_catalogs(tmp_path / "jax.npz").items():
        np.testing.assert_array_equal(catalog.cluster_centers, ref[layer].cluster_centers)


def test_dataset_segmenter_reads_a_pickle_catalog(tmp_path):
    """A semantic-segmentation dir with only catalogs/<k>.pkl: the port's
    segmenter converts it to catalogs/<k>.npz and predicts as from the npz."""
    base = tmp_path / "sem"
    _write_legacy_pickle(base / "catalogs" / "3.pkl", {layer: 4 for layer in COARSE + FINE})
    label_map = {layer: {"0": "background", "1": "printed_text", "2": "handwritten_text"}
                 for layer in COARSE + FINE}
    (base / "merged_classes_3.json").write_text(json.dumps(label_map))
    kwargs = dict(base_dir=base, image_size=16, class_to_color_map=COLORS, keys_to_merge={},
                  only_keep_overlapping=False, keys_for_class_determination=COARSE,
                  keys_for_finegrained_segmentation=FINE, num_clusters=3,
                  min_class_contour_area=2, device="cpu")
    seg = BlackWhiteHandwrittenPrintedTextDatasetSegmenter(**kwargs)
    assert (base / "catalogs" / "3.npz").exists() and set(seg.catalog) == set(COARSE + FINE)
    again = BlackWhiteHandwrittenPrintedTextDatasetSegmenter(**kwargs)  # now from the npz
    for layer in seg.catalog:
        np.testing.assert_array_equal(again.catalog[layer].cluster_centers,
                                      seg.catalog[layer].cluster_centers)
