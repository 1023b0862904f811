"""The port's FID machinery against the JAX package on the CPU:

* `calculate_frechet_distance` against the JAX function on the same
  statistics, within 1e-6 relative (both are numpy and scipy);
* the VGG16 trunk (the fallback embedding) and InceptionV3 features against
  the JAX modules with the same weights carried across (the port's random
  init -> torchvision layout -> the JAX package's converters), within 1e-4
  of max |ref| (float32 convolutions sum in another order); the weights'
  way back (`vgg16_features_params_from_jax`, `inception_v3_params_from_jax`)
  is exact, and `$SIS_METRIC_WEIGHTS/inception_v3.npz` written by the JAX
  package's `save_pytree_npz` loads as the calibrated embedding;
* `preprocess`'s resize to 299 against `jax.image.resize`, within 1e-5;
* `GenerativeFID` of a tiny generator: the same z at every call, the value
  of the statistics computed by hand, real statistics as the JAX FID
  computes them from the same features;
* the real-statistics cache key of the fallback embedding differs from the
  JAX package's;
* a rising FID fires `fid_divergence` in the port's DivergenceAlarm, also
  from an evaluation made after its last trigger."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.evaluation import fid as jax_fid
from synthesis_in_style_tpu.losses.feature_extractors import VGG16Features as JaxVGG16
from synthesis_in_style_tpu.losses.feature_extractors import (
    load_torch_vgg16_features as jax_load_vgg,
)
from synthesis_in_style_tpu.models.inception_v3 import InceptionV3Features as JaxInception
from synthesis_in_style_tpu.models.inception_v3 import load_torch_inception_v3 as jax_load_inc
from synthesis_in_style_tpu.models.inception_v3 import preprocess as jax_preprocess
from synthesis_in_style_tpu.utils.checkpoint import save_pytree_npz
from synthesis_in_style_tpu_torch.core.extensions import DivergenceAlarm, Evaluator
from synthesis_in_style_tpu_torch.core.reporter import Reporter
from synthesis_in_style_tpu_torch.evaluation import fid
from synthesis_in_style_tpu_torch.losses.feature_extractors import (
    VGG16_CONV_IDS,
    VGG16Features,
    imagenet_normalize_from_unit_range,
    init_extractor,
    load_torch_vgg16_features,
)
from synthesis_in_style_tpu_torch.models.inception_v3 import (
    init_inception,
    load_torch_inception_v3,
    preprocess,
)
from synthesis_in_style_tpu_torch.models.stylegan2 import Generator
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    inception_v3_params_from_jax,
    vgg16_features_params_from_jax,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REL_TOL = 1e-4


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _assert_close(got, ref, what):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.max(np.abs(got - ref))
    assert err <= REL_TOL * np.max(np.abs(ref)), (what, err, np.max(np.abs(ref)))


def _random_stats(rng, dim, n):
    feats = rng.normal(size=(n, dim)) @ rng.normal(size=(dim, dim))
    return feats.mean(0) + rng.normal(size=dim), np.cov(feats, rowvar=False)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    for dim, n in ((8, 40), (32, 20)):  # full-rank and rank-deficient covariances
        mu1, s1 = _random_stats(rng, dim, n)
        mu2, s2 = _random_stats(rng, dim, n)
        ref = jax_fid.calculate_frechet_distance(mu1, s1, mu2, s2)
        got = fid.calculate_frechet_distance(mu1, s1, mu2, s2)
        assert abs(got - ref) <= 1e-6 * abs(ref), (dim, got, ref)
        self_distance = fid.calculate_frechet_distance(mu1, s1, mu1, s1)
        assert abs(self_distance) <= 1e-6 * np.trace(s1), self_distance
    stats = fid.get_statistics(rng.normal(size=(10, 4)))
    ref = jax_fid.get_statistics(np.asarray(stats.mu)[None].repeat(2, 0))
    assert stats.mu.shape == (4,) and stats.sigma.shape == (4, 4) and ref.mu.shape == (4,)


def _port_vgg(seed=3):
    vgg = init_extractor(VGG16Features(), seed)
    with torch.no_grad():  # nonzero biases, so those are carried across too
        for conv in vgg.convs:
            conv.bias.copy_(0.05 * torch.randn(conv.bias.shape,
                                               generator=torch.Generator().manual_seed(seed)))
    return vgg.eval()


def test_vgg16_features_match_jax():
    vgg = _port_vgg()
    torchvision_sd = {f"features.{tid}.{k}": getattr(vgg.convs[i], k).detach().numpy()
                      for i, tid in enumerate(VGG16_CONV_IDS) for k in ("weight", "bias")}
    variables = jax_load_vgg(torchvision_sd)
    x = _images(0, (2, 32, 32, 3))
    ref = JaxVGG16().apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert len(got) == len(ref) == 13
    for i, (g, r) in enumerate(zip(got, ref)):
        _assert_close(g.permute(0, 2, 3, 1).numpy(), r, f"tap {i}")
    # the weights' way back is exact, and torchvision's layout loads as well
    back = vgg16_features_params_from_jax(variables)
    for key, value in vgg.state_dict().items():
        assert torch.equal(back[key], value), key
    for key, value in load_torch_vgg16_features(
            {k: torch.from_numpy(v) for k, v in torchvision_sd.items()}).items():
        assert torch.equal(value, vgg.state_dict()[key]), key
    # the fallback's init: a LeCun-scaled truncated normal, biases zero
    fresh = init_extractor(VGG16Features(), 0)
    w = fresh.convs[4].weight
    assert abs(float(w.std()) * (128 * 9) ** 0.5 - 1) < 0.05 and float(w.abs().max()) <= \
        2 / 0.87962566 / (128 * 9) ** 0.5 + 1e-6
    assert not fresh.convs[4].bias.any()
    assert torch.equal(init_extractor(VGG16Features(), 0).convs[0].weight, fresh.convs[0].weight)


def test_imagenet_normalize_matches_jax():
    from synthesis_in_style_tpu.losses.feature_extractors import (
        imagenet_normalize_from_unit_range as jax_normalize,
    )

    x = _images(1, (2, 5, 5, 3))
    np.testing.assert_allclose(imagenet_normalize_from_unit_range(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def _port_inception():
    """A port InceptionV3 with seeded kernels and random BatchNorm scale,
    shift and running statistics (eval mode)."""
    model = init_inception(5)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(1 + 0.2 * torch.rand(n, generator=gen))
    return model


def test_inception_v3_features_match_jax(tmp_path, monkeypatch):
    """80x80 input straight into the trunk (the smallest size its strides
    take; the resize to 299 is held separately), batch 1 and 2."""
    model = _port_inception()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jax.tree_util.tree_map(np.asarray, jax_load_inc(state))
    apply = jax.jit(JaxInception().apply)
    for batch in (1, 2):
        x = _images(batch, (batch, 80, 80, 3))
        ref = apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        _assert_close(got, ref, f"batch {batch}")
    # the way back from the JAX variables is exact
    back = inception_v3_params_from_jax(variables)
    assert set(back) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key
    # a pytorch_fid state dict loads with its classifier dropped
    extra = {**{k: torch.from_numpy(v) for k, v in state.items()},
             "fc.weight": torch.zeros(2, 2), "AuxLogits.conv0.conv.weight": torch.zeros(1)}
    assert set(load_torch_inception_v3(extra)) == set(model.state_dict())
    # $SIS_METRIC_WEIGHTS/inception_v3.npz (the JAX package's converted
    # weights) is the calibrated embedding
    save_pytree_npz(tmp_path / "inception_v3.npz", variables)
    monkeypatch.setenv("SIS_METRIC_WEIGHTS", str(tmp_path))
    feature_fn = fid.calibrated_feature_fn_from_env("cpu")
    x = torch.from_numpy(_images(9, (1, 32, 32, 3)))
    with torch.no_grad():
        expected = model(preprocess(x))
    torch.testing.assert_close(feature_fn(x), expected, rtol=0, atol=0)
    assert fid.FID(device="cpu").feature_name == "inception_v3"
    monkeypatch.setenv("SIS_METRIC_WEIGHTS", str(tmp_path / "missing"))
    assert fid.calibrated_feature_fn_from_env("cpu") is None


def test_preprocess_resize_matches_jax():
    x = _images(2, (1, 32, 24, 3))
    ref = jax_preprocess(jnp.asarray(x))
    got = preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 299, 299, 3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    same = torch.zeros(1, 299, 299, 3)
    assert preprocess(same) is same


class _Batches:
    """A loader stand-in: a fixed list of {"images": NHWC} batches a pass."""

    def __init__(self, images, batch):
        self.batches = [{"images": torch.from_numpy(images[i:i + batch])}
                        for i in range(0, len(images), batch)]

    def __iter__(self):
        return iter(self.batches)


def test_generative_fid_of_a_tiny_generator(tmp_path):
    vgg = _port_vgg()

    @torch.no_grad()
    def feature_fn(images):
        return vgg(images)[-1].mean(dim=(2, 3))

    gen = Generator(16, 32, 2).init_weights(torch.Generator().manual_seed(0)).eval()

    @torch.no_grad()
    def sample(z):
        return gen([z], randomize_noise=False)[0]

    real = _images(4, (10, 16, 16, 3))
    loader = _Batches(real, 4)
    dataset = tmp_path / "val.json"
    metric = fid.GenerativeFID(feature_fn, latent_size=32, batch_size=4, num_samples=6,
                               batch_image_key="images", feature_name="test", device="cpu")
    first = metric(sample, loader, dataset_path=dataset)
    assert np.isfinite(first) and first > 0
    assert metric.cache_path(dataset).exists()
    # the same z at every call: the same value (and the cached real statistics)
    assert metric(sample, loader, dataset_path=dataset) == first

    # by hand: z from a CPU generator seeded 42, two batches of 4, first 6
    z_gen = torch.Generator().manual_seed(42)
    fake = torch.cat([feature_fn(sample(torch.randn((4, 32), generator=z_gen)))
                      for _ in range(2)])[:6].numpy()
    real_feats = feature_fn(torch.from_numpy(real[:8])).numpy()[:6]
    r, f = fid.get_statistics(real_feats), fid.get_statistics(fake)
    expected = fid.calculate_frechet_distance(r.mu, r.sigma, f.mu, f.sigma)
    assert first == pytest.approx(expected, rel=1e-9)

    # real statistics as the JAX FID computes them from the same features
    class JaxLoader:
        def infinite(self):
            while True:
                yield from ({"images": b["images"].numpy()} for b in loader.batches)

    ref = jax_fid.FID(lambda x: feature_fn(torch.from_numpy(np.asarray(x))).numpy(),
                      num_samples=6, batch_image_key="images", feature_name="test")
    ref_stats = ref.calculate_statistics_for_real_images(None, JaxLoader())
    np.testing.assert_allclose(r.mu, ref_stats.mu, rtol=1e-6)
    np.testing.assert_allclose(r.sigma, ref_stats.sigma, rtol=1e-6, atol=1e-9)


def test_fallback_cache_key_differs_from_the_jax_package(monkeypatch):
    monkeypatch.delenv("SIS_METRIC_WEIGHTS", raising=False)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        ours = fid.FID(num_samples=64, device="cpu")
    # the JAX package's naming, without building its random VGG16
    monkeypatch.setattr(jax_fid, "default_feature_fn", lambda: None)
    theirs = jax_fid.FID(num_samples=64)
    assert ours.feature_name == fid.FALLBACK_FEATURE_NAME != theirs.feature_name == "default"
    our_path = ours.cache_path("data/val.json")
    key = f"data/val.json|{theirs.feature_name}|64"
    import hashlib

    their_name = f"fid_stats_{hashlib.sha256(key.encode()).hexdigest()[:16]}.npz"
    assert our_path.parent.name == "data" and our_path.name != their_name
    # the fallback's features: the deepest relu map pooled, 512 wide
    feats = ours.feature_fn(torch.zeros(2, 32, 32, 3))
    assert feats.shape == (2, 512)


def _trainer(log_dir):
    return SimpleNamespace(updater=SimpleNamespace(iteration=0), reporter=Reporter(),
                           log_dir=log_dir)


def test_rising_fid_fires_the_divergence_alarm(tmp_path):
    """Evaluator (priority 250) then DivergenceAlarm (260), as the GAN CLI
    wires them: five evaluations, each higher than the one before, fire
    `fid_divergence` with `fid_rising_evals` 4; `abort` lists the kind, so
    the alarm raises. A falling FID never fires."""
    from synthesis_in_style_tpu_torch.core.extensions import TrainingDiverged

    scores = iter([10.0, 11.0, 12.0, 13.0, 14.0])
    evaluator = Evaluator(lambda t: {"fid_score": next(scores)}, trigger=(5, "iteration"))
    alarm = DivergenceAlarm(trigger=(1, "iteration"), log_dir=tmp_path, fid_rising_evals=4,
                            warmup_iterations=10**6, abort=["fid_divergence"])
    assert evaluator.priority < alarm.priority
    trainer = _trainer(tmp_path)
    with trainer.reporter.scope():
        for i in range(1, 5):
            trainer.updater.iteration = i * 5
            evaluator(trainer)
            alarm(trainer)
        trainer.updater.iteration = 25
        evaluator(trainer)
        with pytest.raises(TrainingDiverged, match="fid_divergence"):
            alarm(trainer)
    record = json.loads((tmp_path / "alarm.json").read_text())
    assert record["kind"] == "fid_divergence" and record["iteration"] == 25
    assert [f for _, f in record["fid_history"]] == [10.0, 11.0, 12.0, 13.0, 14.0]

    falling = iter([14.0, 13.0, 12.0, 11.0, 10.0, 9.0])
    evaluator = Evaluator(lambda t: {"fid_score": next(falling)}, trigger=(5, "iteration"))
    alarm = DivergenceAlarm(trigger=(1, "iteration"), fid_rising_evals=4,
                            warmup_iterations=10**6, abort=True)
    trainer = _trainer(None)
    with trainer.reporter.scope():
        for i in range(1, 6):
            trainer.updater.iteration = i * 5
            evaluator(trainer)
            alarm(trainer)
        # an evaluation after the alarm's last trigger (the end of training)
        trainer.updater.iteration = 27
        evaluator.finalize(trainer)
        alarm.finalize(trainer)
    assert [it for it, _ in alarm.fid_history] == [5, 10, 15, 20, 25, 27]


def test_gan_cli_evaluates_fid_on_val_images(tmp_path):
    """`--val-images` wires the FID Evaluator into the GAN CLI: a 16px run
    of 2 iterations, FID every iteration and at the end on 4 samples; the
    log carries the scores and the alarm's history holds every evaluated
    iteration once."""
    from synthesis_in_style_tpu_torch.cli import train_stylegan_2 as cli
    from synthesis_in_style_tpu_torch.utils.png import write_png

    rs = np.random.RandomState(0)
    names = []
    for i in range(3):
        write_png(tmp_path / f"p{i}.png", rs.randint(0, 256, (16, 16, 3)).astype(np.uint8))
        names.append(f"p{i}.png")
    (tmp_path / "train.json").write_text(json.dumps(names[:2]))
    (tmp_path / "val.json").write_text(json.dumps(names[2:]))
    config = {"image_save_iter": 100, "snapshot_save_iter": 100, "log_iter": 1, "max_iter": 2,
              "batch_size": 2, "lr": 0.001, "latent_size": 32, "n_mlp": 2,
              "channel_multiplier": 2, "stylegan_variant": 2, "image_size": 16,
              "num_workers": 0, "fid_eval_iter": 1, "fid_samples": 4}
    (tmp_path / "config.json").write_text(json.dumps(config))
    argv = [str(tmp_path / "config.json"), "--images", str(tmp_path / "train.json"),
            "--val-images", str(tmp_path / "val.json"), "-l", str(tmp_path / "logs"),
            "-d", "cpu"]
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        trainer = cli.main(cli.resolve_log_dir(cli.build_parser().parse_args(argv)))
    (run,) = (tmp_path / "logs" / "stylegan2").iterdir()
    lines = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    scores = [line["evaluation/fid_score"] for line in lines if "evaluation/fid_score" in line]
    # iterations 1 and 2, and once more at the end (the same z and weights)
    assert len(scores) == 3 and all(np.isfinite(scores)) and scores[1] == scores[2]
    alarm = next(e for e in trainer.extensions if isinstance(e, DivergenceAlarm))
    assert [it for it, _ in alarm.fid_history] == [1, 2]
    assert list(tmp_path.glob("fid_stats_*.npz"))  # the real statistics, cached
