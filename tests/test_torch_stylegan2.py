"""The port's StyleGAN2 generator against the JAX generator on the CPU: the
same flax params carried across with `generator_params_from_jax`, the same
z from numpy, fixed noise buffers. Tolerance: max abs diff <= 1e-4 of the
reference's max |value|, float32 (both compute in float32; the convolutions
and matmuls sum in different orders)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models.stylegan2 import Generator as JaxGenerator
from synthesis_in_style_tpu.utils.checkpoint import save_pytree_npz
from synthesis_in_style_tpu_torch.models.stylegan2 import Generator
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    generator_params_from_jax,
    load_generator_state,
)

SIZE, STYLE_DIM, N_MLP = 32, 64, 2
REL_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _build(channel_multiplier):
    jgen = JaxGenerator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                        channel_multiplier=channel_multiplier)
    # jit: eager flax init compiles op by op and takes several times longer
    variables = jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        [jnp.zeros((1, STYLE_DIM))],
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # nonzero noise weights and biases, so those paths are compared too
    rs = np.random.RandomState(5)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "noise" in name and "weight" in name or name.endswith("['bias']"):
            return (leaf + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return leaf

    variables = {
        "params": jax.tree_util.tree_map_with_path(perturb, variables["params"]),
        "noises": variables["noises"],
    }
    tgen = Generator(SIZE, STYLE_DIM, N_MLP, channel_multiplier=channel_multiplier)
    tgen.load_state_dict(generator_params_from_jax(variables), strict=True)
    tgen.requires_grad_(False)
    return jgen, variables, tgen.eval()


def _assert_close(got, ref, what):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.max(np.abs(got - ref))
    assert err <= REL_TOL * np.max(np.abs(ref)), (what, err, np.max(np.abs(ref)))


def _compare(jgen, variables, tgen, zs, **kwargs):
    j_img, j_acts = jax.jit(
        lambda v, zs: jgen.apply(
            v, zs, randomize_noise=False, return_intermediate_activations=True,
            **{k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
               for k, a in kwargs.items()},
        )
    )(variables, [jnp.asarray(z) for z in zs])
    with torch.no_grad():
        t_img, t_acts = tgen(
            [torch.from_numpy(z) for z in zs], randomize_noise=False,
            return_intermediate_activations=True,
            **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in kwargs.items()},
        )
    _assert_close(t_img, j_img, "image")
    assert sorted(t_acts) == sorted(j_acts) == list(range(tgen.num_layers + 1))
    for k in j_acts:
        _assert_close(t_acts[k], j_acts[k], f"activation {k}")


@pytest.mark.parametrize("channel_multiplier", [2, 1])
def test_generator_matches_jax(channel_multiplier):
    jgen, variables, tgen = _build(channel_multiplier)
    rs = np.random.RandomState(0)
    z0 = rs.randn(2, STYLE_DIM).astype(np.float32)
    z1 = rs.randn(2, STYLE_DIM).astype(np.float32)
    _compare(jgen, variables, tgen, [z0])
    _compare(jgen, variables, tgen, [z0, z1], inject_index=3)
    mean = rs.randn(1, STYLE_DIM).astype(np.float32)
    _compare(jgen, variables, tgen, [z0], truncation=0.7, truncation_latent=mean)


def test_mean_latent_is_mapped_mean():
    jgen, variables, tgen = _build(2)
    z = np.random.RandomState(1).randn(16, STYLE_DIM).astype(np.float32)
    ref = np.asarray(jgen.apply(variables, jnp.asarray(z), method=JaxGenerator.style)).mean(0)
    with torch.no_grad():
        got = tgen.get_latent(torch.from_numpy(z)).mean(0)
    _assert_close(got, ref, "mean latent")


def test_npz_from_save_pytree_npz(tmp_path):
    """The port's loader reads trees written by the JAX package's
    save_pytree_npz: plain variables and a GAN snapshot (g_ema + g_noises)."""
    _, variables, tgen = _build(2)
    expected = tgen.state_dict()
    for name, tree in (
        ("variables.npz", variables),
        ("snapshot.npz", {"g_ema": variables["params"], "g_noises": variables["noises"]}),
    ):
        save_pytree_npz(tmp_path / name, tree)
        state = load_generator_state(tmp_path / name)
        assert sorted(state) == sorted(expected)
        for k, v in expected.items():
            assert torch.equal(state[k], v), k
