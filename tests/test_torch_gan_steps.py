"""Each StyleGAN2 training step of the port against the JAX package's
`make_train_steps` on the CPU: the same start state (JAX params carried
across), the same real batch, and the JAX step's own random draws
(recomputed from its key with `jax.random` and `_sample_inject_index`) fed
to the port's step. Every layer's noise is frozen, so noise comes from the
stored buffers.

What is held is each step's gradients and losses, not parameters after
Adam: Adam's first update is about lr * sign(g), so summation-order noise in
tiny gradients would flip whole lr-sized steps. Both sides hand their
gradients to an optimizer that records them (JAX: an optax transform that
keeps them in its state). Tolerance, per parameter tensor: max abs diff
<= 1e-4 x max|ref| for the D and G steps, 1e-3 for R1 and path length
(second order, more terms summed in another order), float32.

A pre-activation within float32 rounding of 0 can take the other
LeakyReLU branch on one side, which moves that element's gradient by
0.8 g and every gradient upstream of it, as argmin near-ties flip cluster
labels. So the port's CPU convolutions run without oneDNN (whose blocked
float32 sums carry ~6x the rounding error of PyTorch's native path), and
the steps' keys are ones whose draws put no pre-activation that close to 0.
"""

import copy
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthesis_in_style_tpu.models.stylegan2 import Discriminator as JaxDiscriminator
from synthesis_in_style_tpu.models.stylegan2 import Generator as JaxGenerator
from synthesis_in_style_tpu.updaters.stylegan2_updater import (
    StyleGAN2Config as JaxConfig,
    _sample_inject_index,
    create_gan_train_state as jax_create_state,
    make_train_steps,
)
from synthesis_in_style_tpu_torch.models.stylegan2 import Discriminator, Generator
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import (
    GANTrainState,
    MixDraws,
    StyleGAN2Config,
    d_reg_step,
    d_step,
    ema_step,
    g_reg_step,
    g_step,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    discriminator_params_from_jax,
    generator_params_from_jax,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, STYLE_DIM, N_MLP, BATCH = 16, 32, 2, 4
STEP_TOL, REG_TOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _capture():
    """optax transform whose update is zero and whose state is the gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


class Capture:
    """Port optimizer stand-in that records the gradients it is given."""

    def __init__(self, module):
        self.names = [n for n, _ in module.named_parameters()]
        self.grads = None

    def step(self, grads):
        self.grads = {n: None if g is None else g.detach().clone()
                      for n, g in zip(self.names, grads)}


def _perturb(tree):
    rs = np.random.RandomState(7)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']") or "noise" in name and "weight" in name:
            return (leaf + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, tree)


@functools.lru_cache(maxsize=None)
def _setup():
    gen = JaxGenerator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    disc = JaxDiscriminator(size=SIZE)
    tx = _capture()
    state = jax.jit(lambda k: jax_create_state(gen, disc, k, SIZE, tx, tx))(jax.random.PRNGKey(0))
    state = state.replace(g_params=_perturb(state.g_params), d_params=_perturb(state.d_params),
                          mean_path_length=jnp.asarray(0.3, jnp.float32))
    state = jax.tree_util.tree_map(np.asarray, state)
    cfg = JaxConfig(freeze_noise_layers=tuple(range(gen.num_layers)))
    steps = make_train_steps(gen, disc, tx, tx, cfg, BATCH, donate=False)
    real = np.random.RandomState(1).randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    return gen, state, cfg, steps, real


def _port_state(state):
    gen = Generator(SIZE, STYLE_DIM, N_MLP)
    gen.load_state_dict(generator_params_from_jax({"params": state.g_params,
                                                   "noises": state.g_noises}), strict=True)
    disc = Discriminator(SIZE)
    disc.load_state_dict(discriminator_params_from_jax(state.d_params), strict=True)
    return GANTrainState(generator=gen, discriminator=disc,
                         g_ema=copy.deepcopy(gen).requires_grad_(False),
                         g_optimizer=Capture(gen), d_optimizer=Capture(disc),
                         mean_path_length=torch.tensor(float(state.mean_path_length)))


def _port_cfg(jgen):
    return StyleGAN2Config(freeze_noise_layers=tuple(range(jgen.num_layers)))


def _mix_draws(batch, jgen, port_gen, keys):
    """The JAX step's z1, z2 and inject index from its (already split) keys."""
    kz1, kz2, kmix = keys
    z1 = jax.random.normal(kz1, (batch, STYLE_DIM))
    z2 = jax.random.normal(kz2, (batch, STYLE_DIM))
    inject = _sample_inject_index(kmix, 0.9, jgen.n_latent)
    return MixDraws(torch.from_numpy(np.array(z1)), torch.from_numpy(np.array(z2)),
                    torch.tensor(int(inject)), port_gen.noises.nhwc())


def _assert_grads(port_grads, jax_grads_sd, tol, what):
    assert set(port_grads) == set(jax_grads_sd), what
    for name, ref in jax_grads_sd.items():
        got = port_grads[name]
        got = torch.zeros_like(ref) if got is None else got
        ref = ref.numpy()
        err = float(np.max(np.abs(got.numpy() - ref)))
        scale = float(np.max(np.abs(ref)))
        assert err <= tol * scale or scale == err == 0, (what, name, err, scale)


def _d_grads_sd(grads):
    return discriminator_params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _g_grads_sd(grads):
    return generator_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})


def _assert_scalar(got, ref, tol, what):
    ref = float(ref)
    assert abs(float(got) - ref) <= tol * max(1.0, abs(ref)), (what, float(got), ref)


def test_d_step_matches_jax():
    jgen, state, _, steps, real = _setup()
    rng = jax.random.PRNGKey(11)
    new_state, m = steps["d_step"](state, jnp.asarray(real), rng)
    port = _port_state(state)
    kz1, kz2, kmix, _ = jax.random.split(rng, 4)
    draws = _mix_draws(BATCH, jgen, port.generator, (kz1, kz2, kmix))
    pm = d_step(port, _port_cfg(jgen), torch.from_numpy(real), draws)
    for key in ("discriminator_loss", "real_score", "fake_score"):
        _assert_scalar(pm[key], m[key], STEP_TOL, key)
    _assert_grads(port.d_optimizer.grads, _d_grads_sd(new_state.d_opt), STEP_TOL, "d_step")
    assert port.g_optimizer.grads is None  # the D step leaves G alone


def test_d_reg_step_matches_jax():
    jgen, state, _, steps, real = _setup()
    new_state, m = steps["d_reg_step"](state, jnp.asarray(real))
    port = _port_state(state)
    pm = d_reg_step(port, _port_cfg(jgen), torch.from_numpy(real))
    _assert_scalar(pm["r1_penalty"], m["r1_penalty"], REG_TOL, "r1")
    _assert_grads(port.d_optimizer.grads, _d_grads_sd(new_state.d_opt), REG_TOL, "d_reg_step")


def test_g_step_matches_jax():
    jgen, state, _, steps, _ = _setup()
    rng = jax.random.PRNGKey(17)
    new_state, m = steps["g_step"](state, rng)
    port = _port_state(state)
    kz1, kz2, kmix, _ = jax.random.split(rng, 4)
    draws = _mix_draws(BATCH, jgen, port.generator, (kz1, kz2, kmix))
    pm = g_step(port, _port_cfg(jgen), draws)
    _assert_scalar(pm["generator_loss"], m["generator_loss"], STEP_TOL, "g loss")
    _assert_grads(port.g_optimizer.grads, _g_grads_sd(new_state.g_opt), STEP_TOL, "g_step")
    assert port.step == int(new_state.step) == 1


def test_g_reg_step_matches_jax():
    jgen, state, _, steps, _ = _setup()
    rng = jax.random.PRNGKey(13)
    new_state, m = steps["g_reg_step"](state, rng)
    port = _port_state(state)
    path_batch = BATCH // 2
    kz1, kz2, kmix, _, kpl = jax.random.split(rng, 5)
    draws = _mix_draws(path_batch, jgen, port.generator, (kz1, kz2, kmix))
    pl_noise = jax.random.normal(kpl, (path_batch, SIZE, SIZE, 3)) / math.sqrt(SIZE * SIZE)
    pm = g_reg_step(port, _port_cfg(jgen), draws, torch.from_numpy(np.array(pl_noise)))
    for key in ("path_loss", "path_length", "mean_path_length"):
        _assert_scalar(pm[key], m[key], REG_TOL, key)
    _assert_scalar(port.mean_path_length, new_state.mean_path_length, REG_TOL, "state mpl")
    _assert_grads(port.g_optimizer.grads, _g_grads_sd(new_state.g_opt), REG_TOL, "g_reg_step")


def test_ema_step_matches_jax():
    jgen, state, cfg, steps, _ = _setup()
    moved = jax.tree_util.tree_map(lambda p: p + 0.5, state.g_params)
    new_state, _ = steps["ema_step"](state.replace(g_params=moved))
    port = _port_state(state.replace(g_params=moved))
    port.g_ema.load_state_dict(generator_params_from_jax({"params": state.g_ema,
                                                         "noises": state.g_noises}))
    ema_step(port, _port_cfg(jgen))
    ref = generator_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, new_state.g_ema),
                                     "noises": state.g_noises})
    for name, value in port.g_ema.state_dict().items():
        torch.testing.assert_close(value, ref[name], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("step", ["d_step", "g_step"])
def test_bfloat16_steps_run_with_float32_gradients(step):
    """compute_dtype bfloat16: the D and G steps run, and the gradients the
    optimizer gets are float32 and close to the float32 step's (batch 2:
    bfloat16 convolutions are slow on the CPU)."""
    jgen, state, _, _, real = _setup()
    real = real[:2]
    results = {}
    for dtype in (None, "bfloat16"):
        port = _port_state(state)
        cfg = StyleGAN2Config(freeze_noise_layers=tuple(range(jgen.num_layers)),
                              compute_dtype=dtype)
        keys = jax.random.split(jax.random.PRNGKey(14), 4)[:3]
        draws = _mix_draws(2, jgen, port.generator, keys)
        if step == "d_step":
            d_step(port, cfg, torch.from_numpy(real), draws)
            results[dtype] = port.d_optimizer.grads
        else:
            g_step(port, cfg, draws)
            results[dtype] = port.g_optimizer.grads
    for name, g32 in results[None].items():
        g16 = results["bfloat16"][name]
        assert g16.dtype == torch.float32 and torch.isfinite(g16).all(), name
    flat32 = torch.cat([g.flatten() for g in results[None].values()])
    flat16 = torch.cat([g.flatten() for g in results["bfloat16"].values()])
    cos = torch.nn.functional.cosine_similarity(flat32, flat16, dim=0)
    assert cos > 0.99, float(cos)
