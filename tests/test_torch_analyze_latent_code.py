"""The port's analyze_latent_code against the JAX script on the CPU: for the
same latents and noise maps both write the same blueprint JSONs and the
same plot file names (the port draws with PIL, the JAX script with
matplotlib), with and without --stats; and the port script end to end on
a 32px autoencoder snapshot (the embedding cache's keys and shapes, the
blueprints, the cache read back). Tolerance: the blueprints are equal
(both are the same numpy arithmetic on the same arrays)."""

import json

import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.scripts import analyze_latent_code as jalc
from synthesis_in_style_tpu_torch.models import factory
from synthesis_in_style_tpu_torch.scripts import analyze_latent_code as talc
from synthesis_in_style_tpu_torch.utils.checkpoint import save_autoencoder_snapshot
from synthesis_in_style_tpu_torch.utils.png import write_png

from tests.torch_autoencoder_fixtures import remove_files
from tests.torch_threads import one_torch_thread  # noqa: F401


def _codes(seed=0, n=6, slices=2, dim=16):
    rs = np.random.RandomState(seed)
    latents = rs.randn(n, slices, dim).astype(np.float32)
    noises = [rs.randn(n, s, s, 1).astype(np.float32) for s in (4, 8, 8)]
    return latents, noises


def _files(directory):
    return sorted(str(p.relative_to(directory)) for p in directory.rglob("*") if p.is_file())


@pytest.mark.parametrize("stats", [False, True])
def test_blueprints_and_files_equal_the_jax_script(tmp_path, stats):
    latents, noises = _codes()
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    got = talc.analyze_latents(latents, ours / "latents", stats=stats,
                               check_reconstructed_cdf=not stats)
    want = jalc.analyze_latents(latents, theirs / "latents", stats=stats,
                                check_reconstructed_cdf=not stats)
    assert got == want
    assert talc.analyze_noise(noises, ours / "noise") == jalc.analyze_noise(noises,
                                                                            theirs / "noise")
    for name in ("latents/latent_blueprint.json", "noise/noise_blueprint.json"):
        assert json.loads((ours / name).read_text()) == json.loads((theirs / name).read_text())
    assert _files(ours) == _files(theirs)
    assert talc.inverse_cdf_blueprint(latents) == jalc.inverse_cdf_blueprint(latents)
    np.testing.assert_array_equal(
        talc.inverse_cdf_sample(latents, 10, np.random.default_rng(1)),
        jalc.inverse_cdf_sample(latents, 10, np.random.default_rng(1)))


def test_script_end_to_end(tmp_path):
    config = {"image_size": 32, "latent_size": 32, "n_mlp": 2, "channel_multiplier": 1}
    run = tmp_path / "run"
    (run / "config").mkdir(parents=True)
    (run / "config" / "config.json").write_text(json.dumps(config))
    ae = factory.get_autoencoder(config)
    ae.encoder.init_weights(torch.Generator().manual_seed(0))
    ae.decoder.init_weights(torch.Generator().manual_seed(1))
    ckpt = run / "checkpoints" / "ae.pt"
    save_autoencoder_snapshot(ckpt, ae)
    data = tmp_path / "data"
    data.mkdir()
    rs = np.random.RandomState(2)
    names = []
    for i in range(5):
        write_png(data / f"{i}.png", rs.randint(0, 256, (40, 40, 3)).astype(np.uint8))
        names.append(f"{i}.png")
    (data / "images.json").write_text(json.dumps(names))
    out = tmp_path / "analysis"
    argv = [str(ckpt), "--dataset", str(data / "images.json"), "--save-dir", str(out), "-b", "2",
            "-d", "cpu"]
    args = talc.build_parser().parse_args(argv)
    assert talc.build_parser().parse_args(argv[:-2]).device == "cuda"
    blueprints = talc.main(args)
    with np.load(out / "embedded.npz") as cached:
        assert sorted(cached.files) == sorted(["latents", "num_noise_layers"]
                                              + [f"noise_{i}" for i in range(7)])
        latents = cached["latents"]
        assert latents.shape == (5, 8, 32) and int(cached["num_noise_layers"]) == 7
        assert cached["noise_6"].shape == (5, 32, 32, 1)
    assert len(blueprints["noise"]) == 7 and blueprints["latents"]["shape"] == [8, 32]
    for name in ("latents/latent_blueprint.json", "latents/latent_cdf.png",
                 "latents/latent_histogram.png", "latents/latent_dim_015.png",
                 "noise/noise_blueprint.json", "noise/noise_4x4_0_histogram.png"):
        assert (out / name).exists(), name
    # the embedding is the encoder's, in dataset order
    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset

    ds = GANImageDataset(data / "images.json", root=data, image_size=32)
    with torch.no_grad():
        direct = ae.eval().encode(torch.stack([ds[i]["images"] for i in range(5)])).latent
    np.testing.assert_allclose(latents, direct.numpy(), rtol=1e-5, atol=1e-5)
    # a second run reads the cache
    (out / "latents" / "latent_blueprint.json").unlink()
    args.force = False
    talc.main(args)
    assert (out / "latents" / "latent_blueprint.json").exists()
    remove_files(ckpt)
