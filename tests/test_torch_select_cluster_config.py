"""Cluster selection and auto-labelling through the port against the JAX
package's scripts on the CPU (small generator: size 32, latent 32, 2 mapping
layers; the same weights and z on both sides).

* `score_stats` and `labels_from_stats` equal JAX's on random tables;
* the per-(layer, k) statistics tables, fed the JAX generator's activations
  and luminance, within 1e-5 of max|table| of the tables JAX's `stats_fn`
  accumulates, in both class modes (float32 sums in another order; the side
  mode's antialiased resize agrees with jax.image.resize within 2.4e-7,
  held at 5e-7 below);
* both scripts end to end: the same files, label maps and creation config;
* `auto_label_clusters`' `merged_classes_<k>.json` equal to the JAX
  script's, in both modes (the JAX script's appearance filter is
  cv2.filter2D; the port's is a zero-padded box mean, equal on 0/1 maps).
"""

import argparse
import functools
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthesis_in_style_tpu.models.factory as jax_factory
import synthesis_in_style_tpu.utils.dataset_creation as jax_dataset_creation
from synthesis_in_style_tpu.models.stylegan2 import Generator as JaxGenerator
from synthesis_in_style_tpu.scripts import auto_label_clusters as jax_auto_label
from synthesis_in_style_tpu.scripts import select_cluster_config as jax_scc
from synthesis_in_style_tpu.utils.checkpoint import save_pytree_npz
from synthesis_in_style_tpu_torch.scripts import auto_label_clusters as auto_label
from synthesis_in_style_tpu_torch.scripts import select_cluster_config as scc
from synthesis_in_style_tpu_torch.segmentation.factor_catalog import (
    FactorCatalog,
    load_catalogs,
    save_catalogs,
)
from torch_threads import one_torch_thread  # noqa: F401

SIZE, STYLE_DIM, N_MLP, BATCH, SAMPLES = 32, 32, 2, 4, 8
KS = (3, 4)
ARGS = argparse.Namespace(
    left_class="printed_text", right_class="handwritten_text", background_class="background",
    left_threshold=0.6, printed_frac_threshold=0.55,
)


@functools.lru_cache(maxsize=None)
def _generator():
    jgen = JaxGenerator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    variables = jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        [jnp.zeros((1, STYLE_DIM))],
    )
    return jgen, jax.tree_util.tree_map(np.asarray, variables)


def _z_batches(seed=5):
    rs = np.random.RandomState(seed)
    while True:
        yield rs.randn(BATCH, STYLE_DIM).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_batches():
    """[(lum (B, S, S), {layer: acts})] of the JAX generator for the z
    stream, as the JAX selection script computes them."""
    jgen, variables = _generator()
    stream = _z_batches()
    out = []
    for _ in range(SAMPLES // BATCH):
        img, acts = jgen.apply(variables, [jnp.asarray(next(stream))], randomize_noise=False,
                               return_intermediate_activations=True)
        lum = np.asarray(jnp.mean(jnp.clip((img + 1.0) / 2.0, 0.0, 1.0), axis=-1))
        out.append((lum, {str(k): np.asarray(v) for k, v in acts.items()}))
    return out


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
    sem = run / "semantic_segmentation"
    _, acts = _jax_batches()[0]
    rng = np.random.default_rng(0)
    for k in KS + (8,):
        catalogs = {}
        for layer, a in acts.items():
            flat = a.reshape(-1, a.shape[-1])
            cat = FactorCatalog(k)
            cat._kmeans.cluster_centers_ = flat[rng.choice(len(flat), k, replace=False)]
            catalogs[layer] = cat
        save_catalogs(catalogs, sem / "catalogs" / f"{k}.npz")
    return ckpt, sem


def _patch_jax(monkeypatch):
    jgen, variables = _generator()
    stream = _z_batches()
    monkeypatch.setattr(jax_factory, "load_generator", lambda *a, **k: (jgen, variables))
    monkeypatch.setattr(jax_dataset_creation, "build_latent_and_noise_generator",
                        lambda *a, **k: (jnp.asarray(z) for z in stream))


def _patch_port(monkeypatch, module):
    stream = _z_batches()
    monkeypatch.setattr(module, "build_latent_and_noise_generator",
                        lambda *a, **k: (torch.from_numpy(z) for z in stream))


def _random_table(rng, k, zero_rows=0):
    n = rng.integers(0, 5000, k).astype(np.float64)
    n[:zero_rows] = 0
    dark = np.floor(n * rng.random(k))
    return np.stack([n, dark, np.floor(dark * rng.random(k)), n * rng.random(k),
                     np.floor(n * rng.random(k)), np.floor(dark * rng.random(k))], axis=1)


@pytest.mark.parametrize("mode", ["appearance", "side"])
@pytest.mark.parametrize("region", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_stats_and_labels_match_jax(mode, region, seed):
    rng = np.random.default_rng(seed)
    k = 6 + seed
    stats = _random_table(rng, k, zero_rows=seed)
    dark_fraction = rng.uniform(0.1, 0.6)
    got = scc.score_stats(stats, dark_fraction, 0.6, 2.0, region=region, mode=mode)
    want = jax_scc.score_stats(stats, dark_fraction, 0.6, 2.0, region=region, mode=mode)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    args = argparse.Namespace(**vars(ARGS), class_mode=mode)
    assert scc.labels_from_stats(got, k, args) == jax_scc.labels_from_stats(want, k, args)


def _capture_jax_tables(monkeypatch, ckpt, sem, mode):
    """Run the JAX script; return its accumulated (layer, k) tables, in the
    order it scores them (layers ascending, then k)."""
    tables = []
    score = jax_scc.score_stats

    def recording(stats, *args, **kwargs):
        if kwargs.get("region"):
            tables.append(np.array(stats, np.float64))
        return score(stats, *args, **kwargs)

    monkeypatch.setattr(jax_scc, "score_stats", recording)
    _patch_jax(monkeypatch)
    jax_scc.main([str(ckpt), str(sem), "--ks", *map(str, KS), "-n", str(SAMPLES),
                  "-b", str(BATCH), "--class-mode", mode, "--out-tag", "jax"])
    monkeypatch.setattr(jax_scc, "score_stats", score)
    return tables


@pytest.mark.parametrize("mode", ["appearance", "side"])
def test_stats_tables_and_outputs_match_jax(tmp_path, monkeypatch, mode):
    ckpt, sem = _run_dir(tmp_path)
    jax_tables = _capture_jax_tables(monkeypatch, ckpt, sem, mode)

    # the port's statistics on the JAX generator's own activations
    args = scc.build_parser().parse_args([str(ckpt), str(sem), "--ks", "3", "--class-mode", mode])
    catalogs = {k: load_catalogs(sem / "catalogs" / f"{k}.npz") for k in KS}
    layers = sorted(catalogs[KS[0]], key=int)
    port = {}
    for lum, acts in _jax_batches():
        acts = {layer: torch.from_numpy(a) for layer, a in acts.items()}
        feats = scc.layer_features(torch.from_numpy(lum), acts, args,
                                   scc.run_length(SIZE, args.run_len_frac))
        for layer in layers:
            for k in KS:
                s = scc.stats_table(acts[layer], feats[int(acts[layer].shape[1])],
                                    catalogs[k][layer].cluster_centers, k).numpy()
                port[(layer, k)] = port.get((layer, k), 0) + s
    assert len(jax_tables) == len(port)
    for want, (key, got) in zip(jax_tables, port.items()):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key
        res = _jax_batches()[0][1][key[0]].shape[1]
        assert got[:, 0].sum() == want[:, 0].sum() == SAMPLES * res * res

    # both scripts end to end, the port on its own generator (converted weights)
    _patch_port(monkeypatch, scc)
    scc.main([str(ckpt), str(sem), "--ks", *map(str, KS), "-n", str(SAMPLES), "-b", str(BATCH),
              "--class-mode", mode, "--out-tag", "port", "-d", "cpu"])
    for name in ("merged_classes_{}.json", "creation_config_{}.json"):
        assert (json.loads((sem / name.format("port")).read_text())
                == json.loads((sem / name.format("jax")).read_text())), name
    j_report = json.loads((sem / "selection_report_jax.json").read_text())
    t_report = json.loads((sem / "selection_report_port.json").read_text())
    assert t_report["cd_layers"] == j_report["cd_layers"]
    assert t_report["fg_layers"] == j_report["fg_layers"]
    for t_row, j_row in zip(t_report["rows"], j_report["rows"]):
        for key, value in j_row.items():
            if isinstance(value, float):
                assert abs(t_row[key] - value) <= 2e-4, (j_row["layer"], j_row["k"], key)
            else:
                assert t_row[key] == value
    with np.load(sem / "catalogs" / "port.npz") as t, np.load(sem / "catalogs" / "jax.npz") as j:
        assert t.files == j.files
        for name in j.files:
            np.testing.assert_array_equal(t[name], j[name])


@pytest.mark.parametrize("size", [32, 256])
def test_side_resize_matches_jax(size):
    lum = np.random.default_rng(size).random((3, size, size)).astype(np.float32)
    args = argparse.Namespace(dark_threshold=0.55)
    h = 4
    while h <= size:
        want = np.asarray(jax.image.resize(jnp.asarray(lum), (3, h, h), method="linear"))
        feats = scc.side_features(torch.from_numpy(lum), h, h, args).numpy()
        np.testing.assert_allclose(feats[:, 3], want.reshape(-1), rtol=0, atol=5e-7)
        h *= 2


@pytest.mark.parametrize("run_len", [5, 9, 19])
def test_printed_like_matches_filter2d_and_reduce_window(run_len):
    rng = np.random.default_rng(run_len)
    dark = (rng.random((3, 40, 48)) < 0.4).astype(np.float32)
    dark[0] = 0.0
    dark[0, 10, :] = 1.0  # a ruled line on a clean page
    got = scc.printed_like(torch.from_numpy(dark), run_len, 0.35).numpy()
    kh = np.ones((1, run_len), np.float32) / run_len
    for b in range(3):
        hrun = cv2.filter2D(dark[b], -1, kh, borderType=cv2.BORDER_CONSTANT)
        vrun = cv2.filter2D(dark[b], -1, kh.T, borderType=cv2.BORDER_CONSTANT)
        np.testing.assert_array_equal(got[b], (hrun - vrun) > 0.35)

    def box(x, window):
        return jax.lax.reduce_window(x, 0.0, jax.lax.add, window, (1, 1, 1),
                                     [(0, 0)] + [(d // 2, d // 2) for d in window[1:]]) / run_len

    x = jnp.asarray(dark)
    want = np.asarray((box(x, (1, 1, run_len)) - box(x, (1, run_len, 1))) > 0.35)
    np.testing.assert_array_equal(got, want)
    assert got[0, 10, run_len:-run_len].all()


def test_pooled_features_keep_the_sums():
    lum = torch.from_numpy(np.random.default_rng(0).random((2, 32, 32)).astype(np.float32))
    args = argparse.Namespace(dark_threshold=0.55, printed_margin=0.35)
    full = scc.appearance_features(lum, args, 5)
    for h in (4, 8, 16, 32):
        pooled = scc.pooled_features(full, h)
        f = 32 // h
        np.testing.assert_allclose(pooled.sum(0).numpy() * f * f, full.sum((0, 1, 2)).numpy(),
                                   rtol=1e-5)


# random weights paint pages mostly dark and without printed-like strokes:
# in appearance mode a stricter text rule keeps background clusters
@pytest.mark.parametrize("mode,extra", [("appearance", ["--dark-fraction", "0.75"]),
                                        ("side", [])], ids=["appearance", "side"])
def test_auto_label_matches_jax(tmp_path, monkeypatch, mode, extra):
    ckpt, sem = _run_dir(tmp_path)
    argv = [str(ckpt), str(sem), "-k", "8", "-n", str(SAMPLES), "-b", str(BATCH),
            "--mode", mode] + extra
    _patch_jax(monkeypatch)
    jax_auto_label.main(argv)
    want = json.loads((sem / "merged_classes_8.json").read_text())
    (sem / "merged_classes_8.json").unlink()
    _patch_port(monkeypatch, auto_label)
    auto_label.main(argv + ["-d", "cpu"])
    got = json.loads((sem / "merged_classes_8.json").read_text())
    assert got == want
    assert len({name for layer in want.values() for name in layer.values()}) >= 2
