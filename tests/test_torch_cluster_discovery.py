"""Cluster discovery through the port against the JAX package on the CPU, at
a small generator (size 32, latent 32, 2 mapping layers):

* `create_semantic_segmentation` of both packages on the same weights and
  the same z: the same files, array keys, shapes and dtypes, and per
  (layer, k) a mean spherical inertia within 5 % of JAX's (the two fits draw
  from different random streams; both are measured on the same JAX
  activations); the JAX labeller loads the port's artifacts;
* catalogs written by either package load in the other with centres,
  counts and annotations equal;
* the chain discovery -> auto_label_clusters -> create_dataset_for_segmentation
  on the port alone writes [image|label] pairs.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from synthesis_in_style_tpu.cli import create_semantic_segmentation as jax_css
from synthesis_in_style_tpu.labeller.app import Labeller
from synthesis_in_style_tpu.models.stylegan2 import Generator as JaxGenerator
from synthesis_in_style_tpu.segmentation import factor_catalog as jax_catalog
from synthesis_in_style_tpu.utils.checkpoint import save_pytree_npz
from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
from synthesis_in_style_tpu_torch.cli import create_semantic_segmentation as css
from synthesis_in_style_tpu_torch.scripts import auto_label_clusters
from synthesis_in_style_tpu_torch.segmentation import factor_catalog
from synthesis_in_style_tpu_torch.utils.png import read_png
from torch_threads import one_torch_thread  # noqa: F401

SIZE, STYLE_DIM, N_MLP, BATCH, SAMPLES = 32, 32, 2, 4, 16
KS = (3, 5)  # -c 3 5: k = 3 and 4
COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}


@functools.lru_cache(maxsize=None)
def _generator():
    jgen = JaxGenerator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    variables = jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        [jnp.zeros((1, STYLE_DIM))],
    )
    return jgen, jax.tree_util.tree_map(np.asarray, variables)


def _z_batches(seed=3):
    rs = np.random.RandomState(seed)
    while True:
        yield rs.randn(BATCH, STYLE_DIM).astype(np.float32)


def _run_dir(tmp_path):
    run = tmp_path / "run"
    (run / "config").mkdir(parents=True)
    (run / "checkpoints").mkdir()
    config = {"image_size": SIZE, "latent_size": STYLE_DIM, "n_mlp": N_MLP,
              "stylegan_variant": 2, "batch_size": BATCH}
    (run / "config" / "config.json").write_text(json.dumps(config))
    _, variables = _generator()
    ckpt = run / "checkpoints" / "g_ema.npz"
    save_pytree_npz(ckpt, {"g_ema": variables["params"], "g_noises": variables["noises"]})
    return run, ckpt


def _port_stream(monkeypatch, module):
    stream = _z_batches()
    monkeypatch.setattr(module, "build_latent_and_noise_generator",
                        lambda *a, **k: (torch.from_numpy(z) for z in stream))


def _run_jax_cli(monkeypatch, argv):
    jgen, variables = _generator()
    stream = _z_batches()
    monkeypatch.setattr(jax_css, "load_generator", lambda *a, **k: (jgen, variables))
    monkeypatch.setattr(jax_css, "build_latent_and_noise_generator",
                        lambda *a, **k: (jnp.asarray(z) for z in stream))
    jax_css.main(jax_css.build_parser().parse_args(argv))


def _run_port_cli(monkeypatch, argv, report=None):
    _port_stream(monkeypatch, css)
    return css.main(css.build_parser().parse_args(argv + ["-d", "cpu"]), report)


def _jax_activations():
    jgen, variables = _generator()
    stream = _z_batches()
    acts = [jgen.apply(variables, [jnp.asarray(next(stream))], randomize_noise=False,
                       return_intermediate_activations=True)[1]
            for _ in range(SAMPLES // BATCH)]
    return {str(k): np.concatenate([np.asarray(a[k]) for a in acts]) for k in acts[0]}


def _mean_inertia(acts, centers):
    flat = acts.reshape(-1, acts.shape[-1])
    flat = flat / np.sqrt((flat ** 2).sum(1, keepdims=True) + 1e-12)
    return float(np.mean(2 - 2 * (flat @ centers.T).max(axis=1)))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_cli_matches_jax(tmp_path, monkeypatch):
    run, ckpt = _run_dir(tmp_path)
    common = [str(ckpt), "-n", str(SAMPLES), "-b", str(BATCH), "-c", *map(str, KS)]
    _run_jax_cli(monkeypatch, common + ["--destination", "jax"])
    fits = []
    report = _run_port_cli(monkeypatch, common + ["--destination", "port"], fits)
    jax_dir, port_dir = run / "jax", run / "port"
    assert _files(port_dir) == _files(jax_dir)
    acts = _jax_activations()
    for k in range(*KS):
        for sub in ("catalogs", "cluster_labels", "cluster_arrays"):
            with np.load(jax_dir / sub / f"{k}.npz") as j, \
                    np.load(port_dir / sub / f"{k}.npz") as t:
                assert t.files == j.files, (sub, k)
                for name in j.files:
                    assert t[name].shape == j[name].shape, (sub, k, name)
                    assert t[name].dtype == j[name].dtype, (sub, k, name)
        assert (json.loads((port_dir / "catalogs" / f"{k}.annotations.json").read_text())
                == json.loads((jax_dir / "catalogs" / f"{k}.annotations.json").read_text()))
        j_png = np.asarray(Image.open(jax_dir / "cluster_images" / f"{k}.png"))
        t_png = np.asarray(Image.open(port_dir / "cluster_images" / f"{k}.png"))
        assert t_png.shape == j_png.shape and t_png.dtype == j_png.dtype
        # the generated-image row: the two generators' uint8 images, <= 1 apart
        diff = np.abs(t_png[-SIZE:].astype(int) - j_png[-SIZE:])
        assert diff.max() <= 1
        with np.load(jax_dir / "catalogs" / f"{k}.npz") as j, \
                np.load(port_dir / "catalogs" / f"{k}.npz") as t:
            for layer in acts:
                np.testing.assert_allclose(np.linalg.norm(t[f"centers_{layer}"], axis=1), 1.0,
                                           atol=1e-5)
                assert t[f"counts_{layer}"].sum() > 0
                j_inertia = _mean_inertia(acts[layer], j[f"centers_{layer}"])
                t_inertia = _mean_inertia(acts[layer], t[f"centers_{layer}"])
                assert abs(t_inertia - j_inertia) <= 0.05 * j_inertia + 1e-6, (layer, k)
    assert {(f["layer"], f["k"]) for f in fits} == {
        (layer, k) for layer in acts for k in range(*KS)}
    assert report["num_samples"] == SAMPLES
    assert report["activation_bytes"] == sum(a.nbytes for a in acts.values())
    labeller = Labeller(port_dir, KS[0], _colors(tmp_path), max_size=16)
    assert labeller.layer_ids == sorted(acts, key=int)
    assert [a.shape for a in labeller.arrays] == [
        (SAMPLES, 3) + acts[layer].shape[1:3] for layer in labeller.layer_ids]


def _colors(tmp_path):
    path = tmp_path / "colors.json"
    path.write_text(json.dumps(COLORS))
    return path


def test_strip_activations_and_images_flag(tmp_path, monkeypatch):
    run, ckpt = _run_dir(tmp_path)
    fits = []
    _run_port_cli(monkeypatch, [str(ckpt), "-n", "4", "-b", str(BATCH), "-c", "2", "3", "-s", "8"],
                  fits)
    with np.load(run / "semantic_segmentation" / "cluster_labels" / "2.npz") as labels:
        assert labels.files == ["4", "5", "6", "7"]  # 16px and 32px stay
    assert len(fits) == 4
    # -i needs an autoencoder checkpoint: a generator-only one raises as the
    # JAX CLI does
    with pytest.raises(ValueError, match="autoencoder checkpoint"):
        _run_port_cli(monkeypatch, [str(ckpt), "-n", "4", "-i", "images.json"])


def test_catalogs_round_trip_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    centers = {layer: rng.normal(size=(4, 8)).astype(np.float32) for layer in ("3", "12")}
    counts = {layer: rng.integers(0, 99, 4).astype(np.float32) for layer in centers}
    annotations = {"3": {"0": ["printed_text"]}, "12": {}}

    port = {}
    for layer in centers:
        cat = factor_catalog.FactorCatalog(4)
        cat._kmeans.cluster_centers_, cat._kmeans._counts = centers[layer], counts[layer]
        cat.annotations = annotations[layer]
        port[layer] = cat
    factor_catalog.save_catalogs(port, tmp_path / "port.npz")
    jax_read = jax_catalog.load_catalogs(tmp_path / "port.npz")

    jax_cats = {}
    for layer in centers:
        cat = jax_catalog.FactorCatalog(4)
        cat._kmeans.cluster_centers_, cat._kmeans._counts = centers[layer], counts[layer]
        cat.annotations = annotations[layer]
        jax_cats[layer] = cat
    jax_catalog.save_catalogs(jax_cats, tmp_path / "jax.npz")
    port_read = factor_catalog.load_catalogs(tmp_path / "jax.npz")

    for read in (jax_read, port_read):
        assert sorted(read) == sorted(centers)
        for layer, cat in read.items():
            np.testing.assert_array_equal(cat.cluster_centers, centers[layer])
            np.testing.assert_array_equal(cat._kmeans._counts, counts[layer])
            assert cat.annotations == annotations[layer]
    # a catalog without counts (a converted reference pickle) loads with none
    np.savez(tmp_path / "bare.npz", centers_3=centers["3"])
    assert factor_catalog.load_catalogs(tmp_path / "bare.npz")["3"]._kmeans._counts is None


def test_factor_catalog_fit_predict():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 4, 4, 6)).astype(np.float32))
    cat = factor_catalog.FactorCatalog(3, seed=1, batch_size=8)
    labels = cat.fit_predict(x)
    assert labels.shape == (2, 4, 4) and int(labels.max()) < 3
    assert cat.cluster_centers.shape == (3, 6) and cat._kmeans.batch_size == 8
    assert torch.equal(cat.predict(x), labels)
    with pytest.raises(RuntimeError):
        factor_catalog.FactorCatalog(3).predict(x)


def test_discovery_to_dataset_chain(tmp_path, monkeypatch):
    """Port only: discovery, auto-labelling, then the dataset CLI writes
    pairs with the labelled catalog."""
    run, ckpt = _run_dir(tmp_path)
    _run_port_cli(monkeypatch, [str(ckpt), "-n", str(SAMPLES), "-b", str(BATCH), "-c", "4", "5"])
    sem = run / "semantic_segmentation"
    _port_stream(monkeypatch, auto_label_clusters)
    # random weights paint pages mostly dark and their strokes have no side:
    # a stricter text rule than the default 0.4 keeps background clusters,
    # and side mode at 0.5 splits the text clusters into both classes
    auto_label_clusters.main([str(ckpt), str(sem), "-k", "4", "-n", "8", "-b", str(BATCH),
                              "--mode", "side", "--left-threshold", "0.5",
                              "--dark-fraction", "0.75", "-d", "cpu"])
    label_map = json.loads((sem / "merged_classes_4.json").read_text())
    assert sorted(label_map, key=int) == [str(i) for i in range(8)]

    def text_classes(layers):
        return {name for layer in layers for name in label_map[layer].values()} - {"background"}

    # what the dataset segmenter needs of a label map (a human labeller
    # keeps it so): the fine layers' ink is printed_text, and they hold as
    # many text classes as the class-determination layers
    coarse, fine = ["4", "5"], ["6", "7"]
    assert "printed_text" in text_classes(fine)
    assert len(text_classes(coarse)) == len(text_classes(fine)) == 2
    assert any("background" in label_map[layer].values() for layer in coarse)
    creation = {"class_to_color_map": COLORS, "keys_for_class_determination": coarse,
                "keys_for_finegrained_segmentation": fine, "keys_to_merge": {},
                "segmenter_type": "black_white_handwritten_printed",
                "only_keep_overlapping": False, "min_class_contour_area": 2, "seed": 1}
    config_path = tmp_path / "creation_config.json"
    config_path.write_text(json.dumps(creation))
    cds.main(cds.build_parser().parse_args(
        [str(ckpt), str(config_path), "-n", "4", "-b", str(BATCH), "--num-clusters", "4",
         "-d", "cpu"]))
    pngs = sorted((run / "generated_images").glob("**/*.png"))
    assert len(pngs) >= 4
    assert all(read_png(p).shape == (SIZE, 2 * SIZE, 3) for p in pngs)
