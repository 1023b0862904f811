"""Cluster discovery on real images (`create_semantic_segmentation -i`) in
the port against the JAX CLI's pieces on the CPU: the encode-and-decode
activations of the same autoencoder weights (32px, latent 32, narrow
encoder) within 1e-4 of the reference's max |value| (the uint8 images
equal but for rounding ties: at most 1 in 1000 pixels one level apart),
the image stream's order and wrap, the CLI end to end with `-i`, and the
rejection of a generator-only checkpoint."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.cli import create_semantic_segmentation as jcss
from synthesis_in_style_tpu_torch.cli import create_semantic_segmentation as tcss
from synthesis_in_style_tpu_torch.models import factory
from synthesis_in_style_tpu_torch.utils.checkpoint import save_autoencoder_snapshot
from synthesis_in_style_tpu_torch.utils.png import write_png

from tests.torch_autoencoder_fixtures import (
    assert_close,
    images,
    remove_files,
    stylegan_autoencoders,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_encode_generate_matches_jax():
    jmod, variables, tmod = stylegan_autoencoders(seed=6)
    x = images(seed=12)
    j_acts, j_img = jcss.make_encode_generate_fn(jmod, variables)(jnp.asarray(x))
    t_acts, t_img = tcss.make_encode_generate_fn(tmod)(torch.from_numpy(x))
    assert sorted(t_acts) == sorted(j_acts) == list(range(8))
    for k in j_acts:
        assert_close(t_acts[k], j_acts[k], f"activation {k}")
    assert t_img.dtype == torch.uint8 and t_img.shape == (2, 32, 32, 3)
    diff = np.abs(t_img.numpy().astype(int) - np.asarray(j_img).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _write_images(directory, n, seed=0):
    directory.mkdir(parents=True)
    rs = np.random.RandomState(seed)
    names = [f"{i}.png" for i in range(n)]
    for name in names:
        write_png(directory / name, rs.randint(0, 256, (32, 32, 3)).astype(np.uint8))
    (directory / "images.json").write_text(json.dumps(names))
    return directory / "images.json"


def test_image_stream_order_and_wrap(tmp_path):
    listing = _write_images(tmp_path / "imgs", 5)
    stream = tcss.build_image_batch_stream(listing, {"image_size": 32, "batch_size": 2}, "cpu")
    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset

    ds = GANImageDataset(listing, root=listing.parent, image_size=32)
    batches = [next(stream) for _ in range(3)]
    order = [0, 1, 2, 3, 4, 0]
    for i, index in enumerate(order):
        assert torch.equal(batches[i // 2][i % 2], ds[index]["images"])


def _run(tmp_path, ckpt, listing):
    argv = [str(ckpt), "-i", str(listing), "-n", "4", "-b", "2", "-c", "2", "4", "-d", "cpu"]
    return tcss.main(tcss.build_parser().parse_args(argv))


def test_cli_with_images_end_to_end(tmp_path):
    config = {"image_size": 32, "latent_size": 32, "n_mlp": 2, "channel_multiplier": 1}
    run = tmp_path / "run"
    (run / "config").mkdir(parents=True)
    (run / "config" / "config.json").write_text(json.dumps(config))
    ae = factory.get_autoencoder(config)
    ae.encoder.init_weights(torch.Generator().manual_seed(0))
    ae.decoder.init_weights(torch.Generator().manual_seed(1))
    save_autoencoder_snapshot(run / "checkpoints" / "ae.pt", ae)
    listing = _write_images(tmp_path / "imgs", 3)
    report = _run(tmp_path, run / "checkpoints" / "ae.pt", listing)
    assert report["num_samples"] == 4
    sem = run / "semantic_segmentation"
    for k in (2, 3):
        with np.load(sem / "catalogs" / f"{k}.npz") as cat:
            assert len([f for f in cat.files if f.startswith("centers_")]) == 8
        with np.load(sem / "cluster_labels" / f"{k}.npz") as labels:
            assert labels["7"].shape == (4, 32, 32) and labels["7"].dtype == np.int32
        assert (sem / "cluster_images" / f"{k}.png").exists()
    # a generator-only checkpoint cannot embed images
    torch.save({"g_ema": ae.decoder.state_dict()}, run / "checkpoints" / "g.pt")
    with pytest.raises(ValueError, match="autoencoder checkpoint"):
        _run(tmp_path, run / "checkpoints" / "g.pt", listing)
    remove_files(run / "checkpoints" / "ae.pt", run / "checkpoints" / "g.pt")
