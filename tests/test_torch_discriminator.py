"""The port's StyleGAN2 discriminator, and the generator inputs training
uses, against the JAX package on the CPU: the same flax params carried
across (`discriminator_params_from_jax`, `generator_params_from_jax`), the
same inputs from numpy. Tolerance: max abs diff <= 1e-4 of the reference's
max |value|, float32 (the convolutions sum in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models.stylegan2 import Discriminator as JaxDiscriminator
from synthesis_in_style_tpu.models.stylegan2 import Generator as JaxGenerator
from synthesis_in_style_tpu.utils.checkpoint import torch_discriminator_to_flax
from synthesis_in_style_tpu_torch.models.factory import get_discriminator
from synthesis_in_style_tpu_torch.models.stylegan2 import Discriminator, Generator
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    discriminator_params_from_jax,
    generator_params_from_jax,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REL_TOL = 1e-4
BATCH = 4


def _perturb_biases(tree, seed):
    """Nonzero biases (and noise weights), so those paths are compared too."""
    rs = np.random.RandomState(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']") or "noise" in name and "weight" in name:
            return (leaf + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, tree)


@functools.lru_cache(maxsize=None)
def _discriminators(size):
    jdisc = JaxDiscriminator(size=size)
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))["params"]
    params = _perturb_biases(jax.tree_util.tree_map(np.asarray, params), seed=size)
    disc = Discriminator(size)
    disc.load_state_dict(discriminator_params_from_jax(params), strict=True)
    return jdisc, params, disc


def _assert_close(got, ref, what):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.max(np.abs(got - ref))
    assert err <= REL_TOL * np.max(np.abs(ref)), (what, err, np.max(np.abs(ref)))


@pytest.mark.parametrize("size", [16, 32])
def test_discriminator_matches_jax(size):
    jdisc, params, disc = _discriminators(size)
    x = np.random.RandomState(1).randn(BATCH, size, size, 3).astype(np.float32)
    ref = jdisc.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = disc(torch.from_numpy(x))
    assert got.shape == (BATCH, 1)
    _assert_close(got, ref, f"logits {size}px")


def test_discriminator_state_dict_is_reference_layout():
    """The JAX package's converter from the reference layout reads the port's
    state dict back into exactly the JAX params: same keys, same weight
    layouts, the final linear's columns in NCHW-flatten order."""
    _, params, disc = _discriminators(32)
    back = torch_discriminator_to_flax({k: v.numpy() for k, v in disc.state_dict().items()})
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_factory_builds_discriminator():
    disc = get_discriminator({"image_size": 16, "channel_multiplier": 2, "input_dim": 3})
    assert isinstance(disc, Discriminator)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_discriminator({"image_size": 16, "stylegan_variant": "swagan"})


@functools.lru_cache(maxsize=None)
def _generators():
    jgen = JaxGenerator(size=16, style_dim=32, n_mlp=2)
    variables = jax.jit(jgen.init)({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                                   [jnp.zeros((1, 32))])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": _perturb_biases(variables["params"], seed=3),
                 "noises": variables["noises"]}
    gen = Generator(16, 32, 2)
    gen.load_state_dict(generator_params_from_jax(variables), strict=True)
    return jgen, variables, gen.eval()


def test_generator_per_layer_latent_and_noise_list_match_jax():
    """`input_is_latent` with a (B, n_latent, D) latent, an explicit per-layer
    noise list (stored buffers and given planes mixed), and
    `return_latents`."""
    jgen, variables, gen = _generators()
    rs = np.random.RandomState(4)
    latent = rs.randn(BATCH, gen.n_latent, 32).astype(np.float32)
    noise = [variables["noises"][f"noise_{i}"] if i % 2 == 0
             else rs.randn(BATCH, *variables["noises"][f"noise_{i}"].shape[1:]).astype(np.float32)
             for i in range(gen.num_layers)]
    ref_img, ref_lat = jgen.apply(variables, [jnp.asarray(latent)], input_is_latent=True,
                                  noise=[jnp.asarray(n) for n in noise], return_latents=True)
    with torch.no_grad():
        img, lat = gen([torch.from_numpy(latent)], input_is_latent=True,
                       noise=[torch.from_numpy(np.array(n)) for n in noise], return_latents=True)
    _assert_close(img, ref_img, "image")
    _assert_close(lat, ref_lat, "latent")


def test_generator_style_mixing_latents_match_jax():
    jgen, variables, gen = _generators()
    rs = np.random.RandomState(5)
    z1, z2 = (rs.randn(BATCH, 32).astype(np.float32) for _ in range(2))
    _, ref_lat = jgen.apply(variables, [jnp.asarray(z1), jnp.asarray(z2)], inject_index=3,
                            randomize_noise=False, return_latents=True)
    with torch.no_grad():
        _, lat = gen([torch.from_numpy(z1), torch.from_numpy(z2)], inject_index=torch.tensor(3),
                     randomize_noise=False, return_latents=True)
    _assert_close(lat, ref_lat, "mixed latent")


def test_generator_draws_noise_on_the_generators_device():
    _, _, gen = _generators()
    z = torch.zeros(2, 32)
    a, _ = gen([z], generator=torch.Generator().manual_seed(0))
    b, _ = gen([z], generator=torch.Generator().manual_seed(0))
    c, _ = gen([z], generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
