"""The port's StyleGAN1 against the JAX package's on the CPU: the
StyledGenerator at 32px (latent 32, n_mlp 2; step 3, its 64px-and-up
blocks not built) and at 256px's fused upsampling blocks through a 128px
generator (steps 5: the fused path starts at 128px), the
ProgressiveDiscriminator at 32px and 128px (fused downsampling), the
converters and the factory's variant-1 branches. The same flax parameters
carried across, seeded non-zero noise weights and biases, the same
inputs and noise from numpy. Tolerance: 1e-4 of the reference's max
|value| (float32; the convolutions sum in different orders)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models import stylegan1 as j1
from synthesis_in_style_tpu.utils.checkpoint import save_pytree_npz
from synthesis_in_style_tpu_torch.models import factory
from synthesis_in_style_tpu_torch.models import stylegan1 as t1
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    stylegan1_discriminator_params_from_jax,
    stylegan1_generator_params_from_jax,
)

from tests.torch_autoencoder_fixtures import assert_close, numpy_tree
from tests.torch_threads import one_torch_thread  # noqa: F401

LATENT = 32


def _perturbed(params, seed):
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "noise" in name or name.endswith("['bias']"):
            return (x + 0.1 * rs.randn(*x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, numpy_tree(params))


def _noise(size, batch, seed):
    rs = np.random.RandomState(seed)
    step = int(np.log2(size)) - 2
    return [rs.randn(batch, 4 * 2**i, 4 * 2**i, 1).astype(np.float32) for i in range(step + 1)]


@pytest.mark.parametrize("size", [32, 128])
def test_styled_generator_matches_jax(size):
    jgen = j1.StyledGenerator(size=size, code_dim=LATENT, n_mlp=2)
    noise = _noise(size, 2, 1)
    z = np.random.RandomState(0).randn(2, LATENT).astype(np.float32)
    variables = jax.jit(lambda z, n: jgen.init(jax.random.PRNGKey(0), [z], noise=n))(
        jnp.asarray(z), [jnp.asarray(n) for n in noise])
    params = _perturbed(variables["params"], 3)
    tgen = t1.StyledGenerator(size, LATENT, 2)
    tgen.load_state_dict(stylegan1_generator_params_from_jax({"params": params}), strict=True)
    tgen.eval()
    ref_img, ref_acts = jax.jit(lambda p, z, n: jgen.apply(
        {"params": p}, [z], noise=n, return_intermediate_activations=True))(
            params, jnp.asarray(z), [jnp.asarray(n) for n in noise])
    with torch.no_grad():
        img, acts = tgen([torch.from_numpy(z)], noise=[torch.from_numpy(n) for n in noise],
                         return_intermediate_activations=True)
    assert img.shape == (2, size, size, 3)
    assert_close(img, ref_img, "image")
    assert sorted(acts) == sorted(ref_acts)
    for k in ref_acts:
        assert_close(acts[k], ref_acts[k], f"activation {k}")
    # w+ input, as an autoencoder's decoder gets it
    w = np.random.RandomState(2).randn(2, tgen.n_latent, LATENT).astype(np.float32)
    ref, _ = jax.jit(lambda p, w, n: jgen.apply({"params": p}, [w], noise=n,
                                                input_is_latent=True))(
        params, jnp.asarray(w), [jnp.asarray(n) for n in noise])
    with torch.no_grad():
        got, _ = tgen([torch.from_numpy(w)], noise=[torch.from_numpy(n) for n in noise],
                      input_is_latent=True, randomize_noise=False)
    assert_close(got, ref, "image from w+")


@pytest.mark.parametrize("size", [32, 128])
def test_progressive_discriminator_matches_jax(size):
    step = int(np.log2(size)) - 2
    jdisc = j1.ProgressiveDiscriminator(default_step=step)
    x = np.random.RandomState(4).uniform(-1, 1, (4, size, size, 3)).astype(np.float32)
    variables = jax.jit(jdisc.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    params = _perturbed(variables["params"], 5)
    tdisc = t1.ProgressiveDiscriminator(default_step=step)
    tdisc.load_state_dict(stylegan1_discriminator_params_from_jax(params), strict=True)
    ref = jax.jit(lambda p, x: jdisc.apply({"params": p}, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tdisc(torch.from_numpy(x))
    assert got.shape == (4, 1)
    assert_close(got, ref, "logits")


def test_init_draws_and_noise_shapes():
    gen = t1.StyledGenerator(32, LATENT, 2).init_weights(torch.Generator().manual_seed(0))
    assert gen.noise_shapes() == [(1, 4, 4, 1), (1, 8, 8, 1), (1, 16, 16, 1), (1, 32, 32, 1)]
    assert gen.n_latent == 8
    for name, p in gen.named_parameters():
        if ".noise" in name or name.endswith("bias"):
            assert not p.any(), name
    g = torch.Generator().manual_seed(3)
    img, _ = gen([torch.randn(2, LATENT, generator=g)], generator=g)
    assert img.shape == (2, 32, 32, 3) and torch.isfinite(img).all()
    disc = t1.ProgressiveDiscriminator(default_step=3).init_weights(torch.Generator())
    assert torch.isfinite(disc(img)).all()


def test_factory_loads_a_variant1_generator(tmp_path):
    """get_generator / get_discriminator / load_generator for stylegan_variant
    1, from a JAX `save_pytree_npz` snapshot and from a port `.pt`."""
    config = {"image_size": 32, "latent_size": LATENT, "n_mlp": 2, "stylegan_variant": 1}
    assert isinstance(factory.get_generator(config), t1.StyledGenerator)
    assert isinstance(factory.get_discriminator(config), t1.ProgressiveDiscriminator)
    jgen = j1.StyledGenerator(size=32, code_dim=LATENT, n_mlp=2)
    variables = jax.jit(lambda: jgen.init(jax.random.PRNGKey(0), [jnp.zeros((1, LATENT))],
                                          noise=[jnp.zeros((1, 4 * 2**i, 4 * 2**i, 1))
                                                 for i in range(4)]))()
    params = _perturbed(variables["params"], 7)
    (tmp_path / "config").mkdir()
    (tmp_path / "config" / "config.json").write_text(json.dumps(config))
    (tmp_path / "checkpoints").mkdir()
    save_pytree_npz(tmp_path / "checkpoints" / "g.npz", {"g_ema": params})
    gen = factory.load_generator(tmp_path / "checkpoints" / "g.npz", config, device="cpu")
    want = stylegan1_generator_params_from_jax({"params": params})
    for k, v in want.items():
        assert torch.equal(gen.state_dict()[k], v), k
    torch.save({"g_ema": gen.state_dict()}, tmp_path / "checkpoints" / "g.pt")
    again = factory.load_generator(tmp_path / "checkpoints" / "g.pt", config, device="cpu")
    assert all(torch.equal(again.state_dict()[k], v) for k, v in want.items())
