"""The slice as a whole on the CPU: labelled-dataset synthesis through the
port against the JAX package (same weights, same z, same catalog).

(a) the port's front half (generator -> nearest-centre labels) agrees with
    the JAX one on >= 99.9 % of pixels (near-ties in the argmin may flip);
(b) fed the JAX front half's masks, the port's device_segment returns
    bit-identical palette indices and drop flags;
(c) the port's CLI writes the [image|label] PNG layout, train/val JSONs and
    coco_gt.json.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.evaluation.coco_gt import COCOGtCreator
from synthesis_in_style_tpu.models.stylegan2 import Generator as JaxGenerator
from synthesis_in_style_tpu.segmentation.dataset_segmenter import (
    BlackWhiteHandwrittenPrintedTextDatasetSegmenter as JaxSegmenter,
)
from synthesis_in_style_tpu.utils.checkpoint import save_pytree_npz
from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
from synthesis_in_style_tpu_torch.evaluation.coco_gt import has_contour_of_three_points
from synthesis_in_style_tpu_torch.models.stylegan2 import Generator
from synthesis_in_style_tpu_torch.segmentation.dataset_segmenter import (
    BlackWhiteHandwrittenPrintedTextDatasetSegmenter,
)
from synthesis_in_style_tpu_torch.segmentation.device_segmenter import run_device_segment
from synthesis_in_style_tpu_torch.utils.checkpoint import generator_params_from_jax
from synthesis_in_style_tpu_torch.utils.png import read_png

SIZE, STYLE_DIM, N_MLP, K, BATCH = 32, 32, 2, 3, 4
COARSE, FINE = ["4", "5"], ["6", "7"]
CLASSES = ["background", "printed_text", "handwritten_text"]
COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}


@functools.lru_cache(maxsize=None)
def _generators():
    jgen = JaxGenerator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    variables = jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        [jnp.zeros((1, STYLE_DIM))],
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tgen = Generator(SIZE, STYLE_DIM, N_MLP)
    tgen.load_state_dict(generator_params_from_jax(variables))
    return jgen, variables, tgen.eval()


def _z(seed=0):
    return np.random.RandomState(seed).randn(BATCH, STYLE_DIM).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_apply():
    """One jitted JAX forward, so every batch reuses its compilation."""
    jgen, _, _ = _generators()
    return jax.jit(lambda v, z: jgen.apply(
        v, [z], randomize_noise=False, return_intermediate_activations=True))


@functools.lru_cache(maxsize=None)
def _jax_activations(seed):
    """JAX generator activations for z = _z(seed), as numpy."""
    _, variables, _ = _generators()
    _, acts = _jax_apply()(variables, _z(seed))
    return {str(k): np.asarray(v) for k, v in acts.items()}


def _torch_activations(seed):
    _, _, tgen = _generators()
    with torch.no_grad():
        _, acts = tgen([torch.from_numpy(_z(seed))], randomize_noise=False,
                       return_intermediate_activations=True)
    return {str(k): v for k, v in acts.items()}


def _write_artifacts(base_dir):
    """Catalog (a few Lloyd steps from centres sampled from real activations)
    + label map (largest cluster background, then printed, handwritten)."""
    acts = _jax_activations(9)
    rng = np.random.default_rng(0)
    arrays, label_map = {}, {}
    for layer in COARSE + FINE:
        flat = np.asarray(acts[layer]).reshape(-1, acts[layer].shape[-1])
        centers = flat[rng.choice(len(flat), K, replace=False)]
        for _ in range(10):
            assign = ((flat[:, None, :] - centers[None]) ** 2).sum(-1).argmin(1)
            centers = np.stack([flat[assign == i].mean(0) if (assign == i).any() else centers[i]
                                for i in range(K)])
        arrays[f"centers_{layer}"] = centers.astype(np.float32)
        by_size = np.argsort(-np.bincount(assign, minlength=K))
        label_map[layer] = {str(int(c)): CLASSES[rank] for rank, c in enumerate(by_size)}
    (base_dir / "catalogs").mkdir(parents=True)
    np.savez(base_dir / "catalogs" / f"{K}.npz", **arrays)
    (base_dir / f"merged_classes_{K}.json").write_text(json.dumps(label_map))


def _segmenter_kwargs(base_dir, only_keep_overlapping):
    return dict(
        base_dir=base_dir, image_size=SIZE, class_to_color_map=COLORS,
        keys_to_merge={}, only_keep_overlapping=only_keep_overlapping,
        keys_for_class_determination=COARSE, keys_for_finegrained_segmentation=FINE,
        num_clusters=K, min_class_contour_area=2,
    )


def test_front_half_cluster_agreement(tmp_path):
    _write_artifacts(tmp_path)
    jseg = JaxSegmenter(**_segmenter_kwargs(tmp_path, False))
    tseg = BlackWhiteHandwrittenPrintedTextDatasetSegmenter(
        **_segmenter_kwargs(tmp_path, False), device="cpu")
    jacts, tacts = _jax_activations(0), _torch_activations(0)
    agree = total = 0
    for layer in COARSE + FINE:
        jl = np.asarray(jseg.catalog[layer].predict(jnp.asarray(jacts[layer])))
        tl = tseg.catalog[layer].predict(tacts[layer]).numpy()
        agree += int((jl == tl).sum())
        total += jl.size
    fraction = agree / total
    print(f"cluster label agreement {fraction:.6f} over {total} pixels")
    assert fraction >= 0.999, fraction


@pytest.mark.parametrize("only_keep_overlapping", [False, True])
def test_device_segment_bit_identical(tmp_path, only_keep_overlapping):
    _write_artifacts(tmp_path)
    jseg = JaxSegmenter(**_segmenter_kwargs(tmp_path, only_keep_overlapping))
    tseg = BlackWhiteHandwrittenPrintedTextDatasetSegmenter(
        **_segmenter_kwargs(tmp_path, only_keep_overlapping), device="cpu")
    jacts = {k: jnp.asarray(v) for k, v in _jax_activations(0).items() if k in jseg.catalog}
    _, _, compute_masks = jseg._build_prepare_fn()
    masks = compute_masks(jacts)
    j_idx, j_drop = jseg._build_device_segment_fn()(jacts)
    t_idx, t_drop = tseg._build_device_segment_fn().segment_masks(
        {key: torch.from_numpy(np.array(m)) for key, m in masks.items()})
    assert t_idx.dtype == torch.uint8
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_drop.numpy(), np.asarray(j_drop))
    assert (t_idx.numpy() > 0).any()  # something was painted
    # the adapter from {layer: {class: mask}} paints the same indices
    predicted = {}
    for (layer, cls), m in masks.items():
        predicted.setdefault(layer, {})[cls] = np.array(m)
    t_rgb, t_ids = run_device_segment(tseg, predicted, BATCH)
    palette = np.array([[0, 0, 0], [0, 0, 255], [255, 0, 0]], np.uint8)
    np.testing.assert_array_equal(t_rgb, palette[np.asarray(j_idx)])
    assert t_ids == [int(i) for i in np.flatnonzero(np.asarray(j_drop))]


def _cli_run(tmp_path):
    run_dir = tmp_path / "run"
    (run_dir / "config").mkdir(parents=True)
    (run_dir / "checkpoints").mkdir()
    config = {"image_size": SIZE, "latent_size": STYLE_DIM, "n_mlp": N_MLP,
              "stylegan_variant": 2, "batch_size": BATCH}
    (run_dir / "config" / "config.json").write_text(json.dumps(config))
    _, variables, _ = _generators()
    ckpt = run_dir / "checkpoints" / "g_ema.npz"
    save_pytree_npz(ckpt, {"g_ema": variables["params"], "g_noises": variables["noises"]})
    _write_artifacts(run_dir / "semantic_segmentation")
    creation_config = {
        "class_to_color_map": COLORS, "keys_for_class_determination": COARSE,
        "keys_for_finegrained_segmentation": FINE, "keys_to_merge": {},
        "segmenter_type": "black_white_handwritten_printed",
        "only_keep_overlapping": False, "min_class_contour_area": 2, "seed": 1,
    }
    config_path = tmp_path / "creation_config.json"
    config_path.write_text(json.dumps(creation_config))
    return run_dir, [str(ckpt), str(config_path), "-b", str(BATCH), "--num-clusters", str(K),
                     "-d", "cpu"]


def test_cli_writes_dataset(tmp_path):
    run_dir, argv = _cli_run(tmp_path)
    cds.main(cds.build_parser().parse_args(argv + ["-n", "6", "--device-contours"]))
    image_dir = run_dir / "generated_images"
    pngs = sorted(image_dir.glob("**/*.png"))
    assert len(pngs) >= 6
    assert pngs[0].relative_to(image_dir).parts[:2] == ("0", "0")  # id // 100000, id // 1000
    for png in pngs:
        pair = read_png(png)
        assert pair.shape == (SIZE, 2 * SIZE, 3)
        label = pair[:, SIZE:].reshape(-1, 3)
        allowed = {(0, 0, 0), (0, 0, 255), (255, 0, 0)}
        assert {tuple(c) for c in np.unique(label, axis=0)} <= allowed
    train = json.loads((image_dir / "train.json").read_text())
    val = json.loads((image_dir / "val.json").read_text())
    assert len(train) + len(val) == len(pngs) and len(val) >= 1
    for entry in train + val:
        assert (image_dir / entry["file_name"]).exists()
        assert set(entry) == {"file_name", "has_printed_text", "has_handwritten_text"}
    coco = json.loads((image_dir / "coco_gt.json").read_text())
    assert [image["file_name"] for image in coco["images"]] == [e["file_name"] for e in val]


@pytest.mark.parametrize("extra", [["--quantize"], ["--device-contours", "--quantize"],
                                   ["--contour-workers", "2", "--quantize"], []])
def test_cli_unported_options_raise(tmp_path, extra, monkeypatch):
    """`--quantize` (once unported, now the w8a8 generator) runs on each
    back half, and `quantize: true` in the creation config does the same;
    without either the generator stays float."""
    from synthesis_in_style_tpu_torch.models import factory

    built = []
    real = factory.get_generator
    monkeypatch.setattr(factory, "get_generator",
                        lambda config, *a, **k: built.append(real(config, *a, **k)) or built[-1])
    run_dir, argv = _cli_run(tmp_path)
    creation_config = json.loads(open(argv[1]).read())
    written = cds.build_dataset(cds.build_parser().parse_args(argv + extra + ["-n", "2"]),
                                creation_config)
    assert written >= 2 and len(list((run_dir / "generated_images").glob("**/*.png"))) >= 2
    assert [g.quantized for g in built] == [bool(extra)]
    if not extra:
        cds.build_dataset(cds.build_parser().parse_args(argv + ["-n", "2"]),
                          {**creation_config, "quantize": True})
        assert [g.quantized for g in built] == [False, True]


def test_has_class_rule_matches_opencv():
    """has_<class> without OpenCV == the JAX package's cv2 external-contour
    rule (a contour of >= 3 points), on random masks and on lines."""
    rng = np.random.default_rng(0)
    masks = [rng.random((20, 24)) < d for d in (0.01, 0.03, 0.05, 0.1, 0.3)
             for _ in range(40)]
    for line in ([(5, x) for x in range(3, 9)], [(y, 4) for y in range(2, 12)],
                 [(2 + i, 3 + i) for i in range(6)], [(9 - i, 3 + i) for i in range(6)],
                 [(5, 5)], [(5, 5), (5, 6), (6, 6)]):
        m = np.zeros((16, 16), bool)
        for y, x in line:
            m[y, x] = True
        masks.append(m)
    for mask in masks:
        ref = len(COCOGtCreator.extract_rles(mask.astype(np.uint8))) > 0
        assert has_contour_of_three_points(mask) == ref
