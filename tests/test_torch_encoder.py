"""The port's encoders against the JAX package's on the CPU: every variant
at 32px (latent 32; a narrow channel map, 16 channels at 32px and 32
below, so the file stays light), the same flax parameters carried across
with `encoder_params_from_jax` (drawn as the JAX initializers draw them,
`draw_variables`), the same images from numpy. Eval mode runs
on seeded non-trivial BatchNorm statistics; a train-mode forward is held
on its outputs and on the statistics it leaves. Tolerance: 1e-4 of the
reference's max |value| (float32 both sides; the convolutions sum in
different orders)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models import encoder as jenc
from synthesis_in_style_tpu_torch.models import encoder as tenc
from synthesis_in_style_tpu_torch.utils.checkpoint import encoder_params_from_jax

from tests.torch_autoencoder_fixtures import draw_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE, LATENT = 32, 32
SCM = {32: 16, 16: 32, 8: 32, 4: 32}
REL_TOL = 1e-4

VARIANTS = {
    "wplus": (jenc.WPlusEncoder, tenc.WPlusEncoder, {}),
    "wplus_variant1": (jenc.WPlusEncoder, tenc.WPlusEncoder, {"stylegan_variant": 1}),
    "wplus_resnet_noise": (jenc.WPlusResnetNoiseEncoder, tenc.WPlusResnetNoiseEncoder, {}),
    "w": (jenc.WEncoder, tenc.WEncoder, {}),
    "wwplus": (jenc.WWPlusEncoder, tenc.WWPlusEncoder, {}),
    "wplus_no_noise": (jenc.WPlusNoNoiseEncoder, tenc.WPlusNoNoiseEncoder, {}),
    "w_no_noise": (jenc.WNoNoiseEncoder, tenc.WNoNoiseEncoder, {}),
    "noise": (jenc.NoiseEncoder, tenc.NoiseEncoder, {}),
}


def perturbed_stats(stats, seed: int = 3):
    """Seeded BatchNorm statistics (means ~N(0, 0.1), variances in [0.5, 1.5])."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (0.5 + rs.rand(*x.shape)).astype(np.float32)
        return (0.1 * rs.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


_VARIABLES = {}


def _jax_variables(jax_module, seed: int, in_ch: int):
    key = (id(jax_module), seed, in_ch)  # flax modules with a dict field do not hash
    if key not in _VARIABLES:
        variables = draw_variables(jax.eval_shape(
            jax_module.init, jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, in_ch))), seed)
        variables["batch_stats"] = perturbed_stats(variables["batch_stats"], seed + 3)
        _VARIABLES[key] = (jax_module, variables)
    return _VARIABLES[key][1]


def build(jax_module, port_module, seed: int = 0, in_ch: int = 3):
    """(JAX variables with seeded statistics, port module in eval mode)."""
    variables = _jax_variables(jax_module, seed, in_ch)
    port_module.load_state_dict(
        encoder_params_from_jax(variables["params"], variables["batch_stats"]), strict=True)
    return variables, port_module.eval()


def assert_close(got, ref, what, rel=REL_TOL):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)))
    assert err <= rel * max(float(np.max(np.abs(ref))), 1e-30), (what, err, np.abs(ref).max())


def assert_latents_close(got, ref, what):
    assert (got.latent is None) == (ref.latent is None), what
    if ref.latent is not None:
        assert_close(got.latent, ref.latent, f"{what} latent")
    assert (got.noise is None) == (ref.noise is None), what
    if ref.noise is not None:
        assert len(got.noise) == len(ref.noise), what
        for i, (g, r) in enumerate(zip(got.noise, ref.noise)):
            assert_close(g, r, f"{what} noise {i}")
    if hasattr(ref, "code") and ref.code is not None:
        assert_close(got.code, ref.code, f"{what} code")


@functools.lru_cache(maxsize=None)
def _images(batch: int = 2, seed: int = 0, in_ch: int = 3):
    return np.random.RandomState(seed).uniform(-1, 1, (batch, SIZE, SIZE, in_ch)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_module(name):
    jcls, _, kwargs = VARIANTS[name]
    return jcls(SIZE, LATENT, 3, SCM, **kwargs)


def _pair(name):
    _, tcls, kwargs = VARIANTS[name]
    return _jax_module(name), tcls(SIZE, LATENT, 3, SCM, **kwargs)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_encoder_eval_matches_jax(name):
    jmod, tmod = _pair(name)
    variables, tmod = build(jmod, tmod)
    x = _images()
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert_latents_close(got, ref, name)


@pytest.mark.parametrize("name", ["wplus", "wplus_resnet_noise", "w_no_noise"])
def test_encoder_train_mode_matches_jax(name):
    """A train-mode forward: batch statistics, and the running statistics
    it leaves (flax momentum 0.99, biased variance)."""
    jmod, tmod = _pair(name)
    variables, tmod = build(jmod, tmod)
    x = _images(batch=3, seed=1)
    ref, mutated = jax.jit(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    tmod.train()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert_latents_close(got, ref, name)
    want = encoder_params_from_jax(variables["params"],
                                   jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
    state = tmod.state_dict()
    checked = 0
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            assert_close(state[key], value.numpy(), key)
            checked += 1
    assert checked > 0


def test_code_encoder_matches_jax():
    jmod = jenc.WCodeEncoder(8, SIZE, LATENT, 3, SCM)
    tmod = tenc.WCodeEncoder(8, SIZE, LATENT, 3, SCM)
    variables, tmod = build(jmod, tmod)
    x = _images()
    ref = jax.jit(lambda v, x: jmod.apply(v, x))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert isinstance(got, tenc.CodeLatents) and got.code.shape == (2, 8)
    assert_latents_close(got, ref, "wcode")


def test_resnet_encoder_matches_jax():
    jmod, tmod = jenc.Encoder(SIZE, LATENT, 3, SCM), tenc.Encoder(SIZE, LATENT, 3, SCM)
    variables, tmod = build(jmod, tmod)
    x = _images()
    ref = jax.jit(lambda v, x: jmod.apply(v, x))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 8, LATENT)
    assert_close(got, ref, "resnet encoder")


def test_noise_layout_matches_the_generator():
    """Smallest resolution first, (B, H, W, 1): the generator's noise
    list; StyleGAN1 (variant 1) takes one map per resolution."""
    _, tmod = _pair("wplus")
    tmod.init_weights(torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        latents = tmod(torch.from_numpy(_images()))
    assert latents.latent.shape == (2, 8, LATENT)
    assert [tuple(n.shape) for n in latents.noise] == [
        (2, 4, 4, 1), (2, 8, 8, 1), (2, 8, 8, 1), (2, 16, 16, 1), (2, 16, 16, 1),
        (2, 32, 32, 1), (2, 32, 32, 1)]
    _, v1 = _pair("wplus_variant1")
    v1.init_weights(torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        noise = v1(torch.from_numpy(_images())).noise
    assert [n.shape[1] for n in noise] == [4, 8, 16, 32]
