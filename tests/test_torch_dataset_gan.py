"""The port's DatasetGAN modules against the JAX package's on the CPU, same
weights (carried across with `pixel_ensemble_params_from_jax`) and inputs
from numpy.

* `PixelClassifier` (the reference layout) and the stacked ensemble, eval
  and train forward, at K = 3 and K = 40 (the hidden-size switch): logits
  within 1e-5 of max|ref|, train mode's BatchNorm statistics within 1e-6.
* The majority vote against `predict_classes` on rows with tied votes:
  identical.
* k ensemble steps on the same batches against `make_ensemble_train_step`
  with the JAX builder's chain (clip to global norm 1, coupled weight decay,
  Adam): the losses within 1e-5, every parameter within 1e-5 of the largest
  parameter and every running BatchNorm statistic within 1e-6 of the
  largest statistic; one case with gradients above the clip.
* `scale_activations`, bilinear and nearest, against the JAX function.
* `sample_pixel_batches` in both sampling modes: the same pixels and the
  same epoch; the generation dataset's reset seeds and its refreshed
  batches; the dice evaluator.
* The DatasetGAN segmenter's colour images against the JAX segmenter's, on
  the same activations and ensemble, the ensemble read by the JAX
  `load_ensemble` from the port's `.pt` snapshot; the port reading the JAX
  package's `.npz` (stacked, and as `network_<i>` members).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from synthesis_in_style_tpu.data import dataset_gan_dataset as jax_data
from synthesis_in_style_tpu.evaluation import dataset_gan_evaluator as jax_eval
from synthesis_in_style_tpu.models.pixel_classifier import PixelClassifier as JaxClassifier
from synthesis_in_style_tpu.models.pixel_classifier import (
    PixelEnsembleClassifier as JaxEnsemble,
)
from synthesis_in_style_tpu.segmentation import dataset_gan_segmenter as jax_seg
from synthesis_in_style_tpu.updaters.dataset_gan_updater import (
    create_ensemble_train_state,
    make_ensemble_train_step,
)
from synthesis_in_style_tpu.utils.checkpoint import save_pytree_npz
from synthesis_in_style_tpu_torch.data import dataset_gan_dataset as data
from synthesis_in_style_tpu_torch.evaluation import dataset_gan_evaluator as evaluator
from synthesis_in_style_tpu_torch.models.pixel_classifier import (
    PixelClassifier,
    PixelEnsembleClassifier,
    ensemble_from_state,
)
from synthesis_in_style_tpu_torch.segmentation import dataset_gan_segmenter as seg
from synthesis_in_style_tpu_torch.updaters.dataset_gan_updater import (
    EnsembleOptimizer,
    ensemble_train_step,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    pixel_ensemble_params_from_jax,
    save_pixel_ensemble_snapshot,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}
DIM = 24


def _jax_ensemble(num_classes, num_models, dim=DIM, seed=0):
    ensemble = JaxEnsemble(num_classes, dim, num_models, seed=seed)
    ensemble.variables = jax.tree_util.tree_map(np.asarray, ensemble.variables)
    return ensemble


def _port(jax_ensemble) -> PixelEnsembleClassifier:
    return ensemble_from_state(pixel_ensemble_params_from_jax(jax_ensemble.variables),
                               jax_ensemble.num_classes)


def _perturb_bn(jax_ensemble, rng):
    """Non-trivial BatchNorm scale, bias and statistics, so eval mode reads
    them."""
    v = jax_ensemble.variables
    for name in ("bn1", "bn2"):
        shape = v["params"][name]["scale"].shape
        v["params"][name]["scale"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        v["params"][name]["bias"] = rng.normal(0, 0.1, shape).astype(np.float32)
        v["batch_stats"][name]["mean"] = rng.uniform(0, 0.05, shape).astype(np.float32)
        v["batch_stats"][name]["var"] = rng.uniform(0.5, 2.0, shape).astype(np.float32) * 1e-3


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, np.abs(ref).max())


@pytest.mark.parametrize("num_classes", [3, 40])
def test_classifier_forward_matches_flax(num_classes):
    rng = np.random.default_rng(num_classes)
    jax_ens = _jax_ensemble(num_classes, 3)
    _perturb_bn(jax_ens, rng)
    x = rng.normal(size=(64, DIM)).astype(np.float32)
    ensemble = _port(jax_ens)
    assert ensemble.fc1.weight.shape[1] == (128 if num_classes < 32 else 256)

    ensemble.eval()
    with torch.no_grad():
        _close(ensemble(torch.from_numpy(x)), jax_ens.forward_all(jnp.asarray(x)), 1e-5)
    # one member in the reference Sequential layout
    member = PixelClassifier(num_classes, DIM)
    member.load_state_dict(ensemble.member_state_dict(1))
    model = JaxClassifier(num_classes)
    variables = jax.tree_util.tree_map(lambda a: a[1], jax_ens.variables)
    with torch.no_grad():
        _close(member.eval()(torch.from_numpy(x)), model.apply(variables, x, train=False), 1e-5)
    # train mode: batch statistics, and the running statistics they move
    ref, state = model.apply(variables, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        _close(member.train()(torch.from_numpy(x)), ref, 1e-5)
        ensemble.train()
        _close(ensemble(torch.from_numpy(x))[1], ref, 1e-5)
    for name, index in (("bn1", 2), ("bn2", 5)):
        for ours, key in ((member.layers[index].running_mean, "mean"),
                          (member.layers[index].running_var, "var"),
                          (getattr(ensemble, name).running_mean[1], "mean"),
                          (getattr(ensemble, name).running_var[1], "var")):
            _close(ours, state["batch_stats"][name][key], 1e-6)


def test_vote_matches_predict_classes_with_ties():
    jax_ens = _jax_ensemble(3, 4, seed=2)
    x = np.random.default_rng(3).normal(size=(512, DIM)).astype(np.float32) * 4
    votes = np.asarray(jnp.argmax(jax_ens.forward_all(jnp.asarray(x)), axis=-1))
    counts = np.stack([(votes == k).sum(0) for k in range(3)], axis=-1)
    ties = (np.sort(counts, axis=-1)[:, -1] == np.sort(counts, axis=-1)[:, -2]).sum()
    assert ties >= 20  # 2-2 splits between members
    ours = _port(jax_ens).predict_classes(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_ens.predict_classes(jnp.asarray(x))))


def _jax_tx(lr, wd, b1, b2):  # the JAX builder's chain (pixel_ensemble_builder.py)
    return optax.chain(optax.clip_by_global_norm(1.0), optax.add_decayed_weights(wd),
                       optax.adam(lr, b1=b1, b2=b2))


class ClipRecorder(EnsembleOptimizer):
    """Records each step's per-member gradient norms before the clip."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.norms = []

    def step(self, grads):
        self.norms.append(torch.stack([g.square().flatten(1).sum(1) for g in grads]).sum(0).sqrt())
        super().step(grads)


@pytest.mark.parametrize("batch, scale, clipped", [(256, 1.0, False), (32, 30.0, True)])
def test_ensemble_steps_match_jax(batch, scale, clipped):
    rng = np.random.default_rng(5)
    lr, wd, b1, b2, steps = 5e-4, 1e-4, 0.5, 0.999, 3
    jax_ens = _jax_ensemble(3, 3, seed=4)
    ensemble = _port(jax_ens)
    tx = _jax_tx(lr, wd, b1, b2)
    state = create_ensemble_train_state(jax_ens, tx)
    step = make_ensemble_train_step(jax_ens.model, tx, donate=False)
    optimizer = ClipRecorder(ensemble, lr, (b1, b2), weight_decay=wd)
    for _ in range(steps):
        x = (rng.normal(size=(batch, DIM)) * scale).astype(np.float32)
        y = rng.integers(0, 3, batch).astype(np.int32)
        state, ref_losses = step(state, {"activations": jnp.asarray(x), "label": jnp.asarray(y)})
        losses = ensemble_train_step(ensemble, optimizer,
                                     {"activations": torch.from_numpy(x),
                                      "label": torch.from_numpy(y)})
        _close(losses, ref_losses, 1e-5)
    norms = torch.stack(optimizer.norms)
    assert bool((norms > 1).all()) if clipped else bool((norms < 1).all()), norms
    ref = pixel_ensemble_params_from_jax(jax.tree_util.tree_map(np.asarray, state.variables))
    # held against the largest value of its kind: Adam's update of an element
    # whose gradient is small against its history carries that gradient's
    # float32 rounding (up to 7e-4 of the update measured in the clipped case)
    for stats, tol in ((False, 1e-5), (True, 1e-6)):
        keys = [k for k in ref if ("running" in k) == stats]
        scale = max(float(ref[k].abs().max()) for k in keys)
        for key in keys:
            err = float((ensemble.state_dict()[key] - ref[key]).abs().max())
            assert err <= tol * scale, (key, err, scale)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_scale_activations_matches_jax(method):
    rng = np.random.default_rng(7)
    acts = {i: rng.normal(size=(2, s, s, c)).astype(np.float32)
            for i, (s, c) in enumerate([(2, 3), (4, 5), (8, 2), (16, 4), (32, 3)])}
    ref = np.asarray(jax_seg.scale_activations({k: jnp.asarray(v) for k, v in acts.items()},
                                               32, method))
    ours = seg.scale_activations({k: torch.from_numpy(v) for k, v in acts.items()}, 32,
                                 method).numpy()
    if method == "nearest":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


SIZE = 8
LAYERS = ((2, 3), (4, 2), (8, 3))  # (resolution, channels) of the stored layers


def _write_dataset(root, rng, n=3):
    """An activation CLI layout: label PNGs, a manifest, tensors.npz with
    latents and per-image activation dicts."""
    palette = np.array([[0, 0, 0], [0, 0, 255], [255, 0, 0]], np.uint8)
    entries, acts = [], []
    for i in range(n):
        Image.fromarray(palette[rng.integers(0, 3, (SIZE, SIZE))]).save(root / f"label_{i}.png")
        Image.fromarray(np.zeros((SIZE, SIZE, 3), np.uint8)).save(root / f"image_{i}.png")
        acts.append({str(k): rng.normal(size=(s, s, c)).astype(np.float32)
                     for k, (s, c) in enumerate(LAYERS)})
        entries.append({"image": f"image_{i}.png", "label": f"label_{i}.png",
                        "activations": i, "latent": i})
    np.savez_compressed(root / "tensors", latent_codes=rng.normal(size=(n, 4)).astype(np.float32),
                        activations=np.asarray(acts, dtype=object))
    (root / "train.json").write_text(json.dumps(entries))
    (root / "colors.json").write_text(json.dumps(COLORS))


def _datasets(root, **kwargs):
    common = dict(json_path=root / "train.json", tensor_path=root / "tensors.npz",
                  class_to_color_map_path=root / "colors.json", image_size=SIZE, **kwargs)
    return jax_data.DatasetGANDataset(**common), data.DatasetGANDataset(device="cpu", **common)


@pytest.mark.parametrize("random_sampling", [False, True])
def test_pixel_batches_match_jax(tmp_path, random_sampling):
    _write_dataset(tmp_path, np.random.default_rng(11))
    kwargs = dict(random_sampling=random_sampling)
    if random_sampling:
        kwargs["class_probabilities"] = [0.2, 0.5, 0.3]
    jax_ds, ours = _datasets(tmp_path, **kwargs)
    np.testing.assert_array_equal(ours.pixel_labels, jax_ds.pixel_labels)
    np.testing.assert_allclose(ours.pixel_activations.numpy(), jax_ds.pixel_activations,
                               rtol=0, atol=1e-6)
    assert len(ours) == len(jax_ds) and ours.get_feature_vector_length() == 8
    ref_stream, stream = jax_ds.sample_pixel_batches(16, seed=3), ours.sample_pixel_batches(16, 3)
    for _ in range(5):
        ref, got = next(ref_stream), next(stream)
        np.testing.assert_array_equal(got["label"].numpy(), ref["label"])
        np.testing.assert_allclose(got["activations"].numpy(), ref["activations"],
                                   rtol=0, atol=1e-6)
        assert ours.epoch == jax_ds.epoch


def test_generation_dataset_reset_refreshes_batches(tmp_path):
    """reset_dataset() changes what the stream serves (the store is
    rewritten in place), and its noise seeds are the JAX dataset's."""
    _write_dataset(tmp_path, np.random.default_rng(12))
    common = dict(json_path=tmp_path / "train.json", tensor_path=tmp_path / "tensors.npz",
                  class_to_color_map_path=tmp_path / "colors.json", image_size=SIZE)
    jax_seeds, seeds, calls = [], [], {"n": 0}

    def jax_fn(latents, seed):
        jax_seeds.append(seed)
        return {0: jnp.zeros((len(latents), 4, 4, 2))}

    def generator_fn(latents, generator):
        calls["n"] += 1
        seeds.append(generator.initial_seed())
        return {0: torch.full((len(latents), 4, 4, 2), float(calls["n"]))}

    jax_ds = jax_data.DatasetGANGenerationDataset(generator_fn=jax_fn, **common)
    ours = data.DatasetGANGenerationDataset(generator_fn=generator_fn, device="cpu", **common)
    stream = ours.sample_pixel_batches(batch_size=4, seed=0)
    first = next(stream)["activations"].clone()
    store = ours.pixel_activations
    ours.reset_dataset()
    jax_ds.reset_dataset()
    assert ours.pixel_activations is store
    assert not torch.allclose(first, next(stream)["activations"])
    # three images, two a call: two generator calls a reset, one seed a reset
    assert calls["n"] == 4 and seeds[0] == seeds[1] and seeds[2] == seeds[3]
    assert [seeds[0], seeds[2]] == jax_seeds


def test_dice_matches_jax():
    rng = np.random.default_rng(13)
    pred, gt = rng.integers(0, 3, (4, 50)), rng.integers(0, 3, (4, 50))
    assert evaluator.calculate_dice_coefficient(torch.from_numpy(pred), torch.from_numpy(gt)) == \
        pytest.approx(jax_eval.calculate_dice_coefficient(pred, gt), rel=1e-6)
    jax_ens = _jax_ensemble(3, 3)
    batches = [{"activations": rng.normal(size=(40, DIM)).astype(np.float32),
                "label": rng.integers(0, 3, 40).astype(np.int32)} for _ in range(3)]
    ref = jax_eval.make_dataset_gan_eval_fn(jax_ens, lambda: batches)(None)
    ours = evaluator.make_dataset_gan_eval_fn(
        _port(jax_ens), lambda: ({k: torch.from_numpy(v) for k, v in b.items()}
                                 for b in batches))(None)
    assert ours["Dice Score"] == pytest.approx(ref["Dice Score"], rel=1e-6)
    assert evaluator.make_dataset_gan_eval_fn(_port(jax_ens), lambda: [])(None) == {}


def _port_snapshot(path, ensemble):
    optimizer = EnsembleOptimizer(ensemble, 1e-3)
    save_pixel_ensemble_snapshot(path, [ensemble.member_state_dict(i) for i in range(3)],
                                 optimizer.member_state_dicts(), 7)


def test_segmenter_colour_images_match_jax(tmp_path):
    rng = np.random.default_rng(17)
    jax_ens = _jax_ensemble(3, 3, dim=14, seed=9)
    _perturb_bn(jax_ens, rng)
    snapshot = tmp_path / "iter_00000007.pt"
    _port_snapshot(snapshot, _port(jax_ens))
    acts = {i: (rng.normal(size=(3, s, s, c)) * 3).astype(np.float32)
            for i, (s, c) in enumerate([(4, 4), (8, 4), (16, 3), (32, 3)])}
    common = dict(base_dir=tmp_path, image_size=32, class_to_color_map=COLORS,
                  classifier_path=snapshot)
    ref, ref_drop = jax_seg.DatasetGANSegmenter(**common).create_segmentation_image(
        {k: jnp.asarray(v) for k, v in acts.items()})
    ours, drop = seg.DatasetGANSegmenter(device="cpu", **common).create_segmentation_image(
        {k: torch.from_numpy(v) for k, v in acts.items()})
    assert drop == ref_drop == []
    assert ours.dtype == np.uint8 and ours.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(ours, np.asarray(ref))
    assert len({tuple(c) for c in ours.reshape(-1, 3)}) >= 2


@pytest.mark.parametrize("layout", ["pixel_ensemble", "members"])
def test_port_reads_jax_npz(tmp_path, layout):
    jax_ens = _jax_ensemble(3, 3, seed=21)
    _perturb_bn(jax_ens, np.random.default_rng(21))
    v = jax_ens.variables
    tree = ({"pixel_ensemble": v} if layout == "pixel_ensemble" else
            {f"network_{i}": jax.tree_util.tree_map(lambda a: a[i], v) for i in range(3)})
    save_pytree_npz(tmp_path / "ensemble.npz", tree)
    ensemble = seg.load_ensemble(tmp_path / "ensemble.npz", 3, "cpu")
    x = np.random.default_rng(22).normal(size=(50, DIM)).astype(np.float32)
    with torch.no_grad():
        _close(ensemble(torch.from_numpy(x)), jax_ens.forward_all(jnp.asarray(x)), 1e-5)
