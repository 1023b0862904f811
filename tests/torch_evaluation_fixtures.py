"""Shared builders of the evaluation parity tests (evaluate_checkpoints,
fid_trend): a 32px generator config, JAX variables drawn with
`jax.eval_shape` and seeded numpy draws (no compiled init), checkpoints
written in both packages' formats (an orbax directory for the JAX package,
the same tree as a `save_pytree_npz` `.npz` for the port) beside their
`config/config.json`, seeded real pages, and the two monkeypatches that
make both packages' FID comparable: one VGG16 embedding (the port's
seeded trunk carried into the JAX package) and one z stream."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from synthesis_in_style_tpu.evaluation import fid as jax_fid
from synthesis_in_style_tpu.losses.feature_extractors import (
    load_torch_vgg16_features as jax_load_vgg,
)
from synthesis_in_style_tpu.models import factory as jax_factory
from synthesis_in_style_tpu.utils.checkpoint import save_pytree, save_pytree_npz
from synthesis_in_style_tpu_torch.evaluation import fid
from synthesis_in_style_tpu_torch.losses.feature_extractors import (
    VGG16_CONV_IDS,
    VGG16Features,
    init_extractor,
)
from synthesis_in_style_tpu_torch.utils.png import write_png

from tests.torch_autoencoder_fixtures import draw_variables, init_jax

SIZE, LATENT = 32, 32
CONFIG = {"image_size": SIZE, "latent_size": LATENT, "n_mlp": 2, "channel_multiplier": 1,
          "stylegan_variant": 2, "input_dim": 3}


def generator_variables(seed: int) -> dict:
    """A JAX generator's variables (params with the mapping network, noises)."""
    gen = jax_factory.get_generator(CONFIG)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: gen.init({"params": key, "noise": key},
                                             [jnp.zeros((1, LATENT))]))
    return draw_variables(shapes, seed)


def autoencoder_variables(seed: int) -> dict:
    """The factory's w+ autoencoder (its encoder on StyleGAN2's channel map)."""
    module = jax_factory.get_autoencoder(CONFIG, "wplus")
    return init_jax(module, jnp.zeros((1, SIZE, SIZE, 3)), seed=seed)


def write_checkpoint(root, name: str, tree: dict) -> tuple:
    """(JAX orbax directory, port .npz) of one tree, each in a run directory
    of its own with the config beside it: `<root>/{jax,port}/<name-run>/
    checkpoints/<name>[.npz]`."""
    out = []
    for kind in ("jax", "port"):
        run = root / kind / f"{name}_run"
        (run / "config").mkdir(parents=True, exist_ok=True)
        (run / "config" / "config.json").write_text(json.dumps(CONFIG))
        (run / "checkpoints").mkdir(exist_ok=True)
        path = run / "checkpoints" / (name if kind == "jax" else f"{name}.npz")
        if kind == "jax":
            save_pytree(path, tree)
        else:
            save_pytree_npz(path, tree)
        out.append(path)
    return tuple(out)


def generator_tree(seed: int) -> dict:
    variables = generator_variables(seed)
    return {"g_ema": variables["params"], "g_noises": variables["noises"]}


def autoencoder_tree(seed: int) -> dict:
    """An autoencoder snapshot and, as its g_ema, its decoder with a mapping
    network (a decoder that only decoded w+ has none)."""
    variables = autoencoder_variables(seed)
    params = {**generator_variables(seed + 1)["params"], **variables["params"]["decoder"]}
    return {"autoencoder": variables, "g_ema": params,
            "g_noises": variables["noises"]["decoder"]}


def write_pages(directory, n: int, seed: int = 0) -> list:
    """Seeded SIZE x SIZE RGB PNGs (dark strokes on light paper)."""
    directory.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    names = []
    for i in range(n):
        page = np.full((SIZE, SIZE, 3), 220, np.uint8) + rs.randint(0, 30, (SIZE, SIZE, 1)
                                                                     ).astype(np.uint8)
        for _ in range(4):
            y, x = rs.randint(0, SIZE - 4, 2)
            page[y:y + 2, x:x + rs.randint(4, 12)] = rs.randint(0, 60)
        write_png(directory / f"page_{i}.png", page)
        names.append(f"page_{i}.png")
    (directory / "val.json").write_text(json.dumps(names))
    return names


def same_features(monkeypatch) -> None:
    """Both packages' default FID embedding becomes one seeded VGG16 (the
    port's init, carried into the JAX package's layout)."""
    monkeypatch.delenv("SIS_METRIC_WEIGHTS", raising=False)
    vgg = init_extractor(VGG16Features(), 3)
    with torch.no_grad():
        for conv in vgg.convs:
            conv.bias.copy_(0.05 * torch.randn(conv.bias.shape,
                                               generator=torch.Generator().manual_seed(3)))
    torchvision_sd = {f"features.{tid}.{k}": getattr(vgg.convs[i], k).detach().numpy()
                      for i, tid in enumerate(VGG16_CONV_IDS) for k in ("weight", "bias")}
    port_state = vgg.state_dict()
    # one jitted JAX trunk for every FID object (the JAX function jits a
    # new one at each call)
    jax_features = jax_fid.default_feature_fn(jax_load_vgg(torchvision_sd))
    port_default = fid.default_feature_fn
    monkeypatch.setattr(jax_fid, "default_feature_fn",
                        lambda variables=None, dim=512: jax_features)
    monkeypatch.setattr(fid, "default_feature_fn",
                        lambda state_dict=None, device="cpu", seed=0: port_default(
                            port_state, device))


def _z_stream(batch: int, latent: int):
    rs = np.random.RandomState(7)
    while True:
        yield rs.randn(batch, latent).astype(np.float32)


def same_z(monkeypatch) -> None:
    """Both packages' GenerativeFID draw z from one seeded numpy stream."""
    def jax_fake(self, model_fn, data_loader):
        for z in _z_stream(self.batch_size, self.latent_size):
            yield np.asarray(model_fn(jnp.asarray(z)))

    def port_fake(self, model_fn, data_loader):
        for z in _z_stream(self.batch_size, self.latent_size):
            yield model_fn(torch.from_numpy(z).to(self.device))

    monkeypatch.setattr(jax_fid.GenerativeFID, "fake_batches", jax_fake)
    monkeypatch.setattr(fid.GenerativeFID, "fake_batches", port_fake)
