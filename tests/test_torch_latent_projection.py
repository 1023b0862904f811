"""The port's latent projection against the JAX package's on the CPU (a
32px generator, latent 32, n_mlp 2, channel multiplier 1, with seeded
non-zero noise weights so that the noise stage has a gradient): the
learning-rate schedule at every step, and the w+ stage (LPIPS) and the
noise stage (MSE) step for step over their first 3 steps. Tolerances: the
schedule within 1e-6 relative (float32 in JAX, float64 here); the latents
and noise maps after each step within 1e-4 of the reference's max |value|
(Adam's first steps are lr * sign(g): an element whose gradient were within
rounding of 0 would differ by 2 lr; none is at these seeds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu import latent_projecting as jlp
from synthesis_in_style_tpu.models.encoder import Latents as JaxLatents
from synthesis_in_style_tpu_torch import latent_projecting as tlp
from synthesis_in_style_tpu_torch.losses.perceptual import PerceptualAndStyleLoss
from synthesis_in_style_tpu_torch.models.encoder import Latents
from synthesis_in_style_tpu_torch.utils.checkpoint import generator_params_from_jax

from tests.torch_autoencoder_fixtures import (
    LATENT,
    assert_close,
    images,
    jax_decoder,
    lpips_pair,
    numpy_tree,
    port_decoder,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("total", [1, 7, 100, 1000])
def test_lr_with_ramp_matches_jax_at_every_step(total):
    j = jlp.lr_with_ramp(0.1, total)
    t = tlp.lr_with_ramp(0.1, total)
    assert t(0) == 0.0
    for step in range(total + 1):
        ref = float(j(step))
        assert abs(t(step) - ref) <= 1e-6 * max(abs(ref), 1e-3), (step, t(step), ref)


def _generators():
    jgen = jax_decoder()
    variables = jax.jit(jgen.init)({"params": jax.random.PRNGKey(0),
                                    "noise": jax.random.PRNGKey(1)}, [jnp.zeros((1, LATENT))])
    variables = numpy_tree(variables)
    rs = np.random.RandomState(3)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        if "noise" in name and "weight" in name:  # 0 at init: no noise gradient
            return (0.1 + 0.1 * rs.rand(*x.shape)).astype(np.float32)
        return x

    variables = {"params": jax.tree_util.tree_map_with_path(perturb, variables["params"]),
                 "noises": variables["noises"]}
    tgen = port_decoder()
    tgen.load_state_dict(generator_params_from_jax(variables), strict=True)
    return jgen, variables, tgen.eval()


def _start(tgen, batch=1, seed=4):
    rs = np.random.RandomState(seed)
    latent = rs.randn(batch, tgen.n_latent, LATENT).astype(np.float32)
    noise = [rs.randn(batch, *s[1:]).astype(np.float32) for s in tgen.noise_shapes()]
    return latent, noise


def _assert_paths(tpaths, jpaths, what):
    assert len(tpaths) == len(jpaths)
    for i, (t, j) in enumerate(zip(tpaths, jpaths)):
        assert_close(t.latent, np.asarray(j.latent), f"{what} step {i} latent")
        for k, (tn, jn) in enumerate(zip(t.noise, j.noise)):
            assert_close(tn, np.asarray(jn), f"{what} step {i} noise {k}")


def test_projection_stages_match_jax_step_for_step():
    jgen, variables, tgen = _generators()
    jl, tl = lpips_pair("alex")
    target = images(batch=1, seed=9)
    latent, noise = _start(tgen)
    jlat = JaxLatents(latent=jnp.asarray(latent), noise=tuple(jnp.asarray(n) for n in noise))
    tlat = Latents(latent=torch.from_numpy(latent), noise=tuple(torch.from_numpy(n) for n in noise))
    jproj, tproj = jlp.Projector(jgen, variables), tlp.Projector(tgen)
    j_loss = jlp.w_plus_loss({"l_percept": 1.0, "l_mse": 0.5}, jl)
    t_loss = tlp.w_plus_loss({"l_percept": 1.0, "l_mse": 0.5}, tl)
    jpaths, jbest = jproj.project(jlat, jnp.asarray(target), j_loss, 3, 0.1, optimize="latent",
                                  snapshot_every=1)
    tpaths, tbest = tproj.project(tlat, torch.from_numpy(target), t_loss, 3, 0.1,
                                  optimize="latent", snapshot_every=1)
    _assert_paths(tpaths, jpaths, "w+")
    assert not np.allclose(tpaths.items[-1].latent, latent)  # the stage moved
    for i, n in enumerate(noise):  # and left the noise alone
        np.testing.assert_array_equal(tbest.noise[i].numpy(), n)
    jpaths, _ = jproj.project(jbest, jnp.asarray(target), jlp.naive_noise_loss({"l_mse": 1.0}),
                              3, 5.0, optimize="noise", snapshot_every=1)
    tpaths, tbest2 = tproj.project(tbest, torch.from_numpy(target),
                                   tlp.naive_noise_loss({"l_mse": 1.0}), 3, 5.0,
                                   optimize="noise", snapshot_every=1)
    _assert_paths(tpaths, jpaths, "noise")
    assert any(not np.allclose(a.numpy(), b.numpy()) for a, b in zip(tbest2.noise, tbest.noise))
    np.testing.assert_array_equal(tbest2.latent.numpy(), tbest.latent.numpy())
    assert not any(p.requires_grad for p in tgen.parameters())


def test_reconstruction_and_local_style_transfer_run():
    _, _, tgen = _generators()
    _, tl = lpips_pair("alex")
    latent, noise = _start(tgen, batch=2, seed=6)
    lat = Latents(latent=torch.from_numpy(latent), noise=tuple(torch.from_numpy(n) for n in noise))
    target = torch.from_numpy(images(seed=10))
    proj = tlp.Projector(tgen)
    losses = []
    paths, best = tlp.run_image_reconstruction(
        proj, lat, target, tl, latent_step=3, noise_step=2, snapshot_every=2,
        latent_abort_condition=lambda loss, i: losses.append(loss) or False)
    assert len(losses) == 3 and len(paths) == 2 + 1
    assert best.latent.shape == lat.latent.shape and len(best.noise) == len(noise)
    stopped = []
    tlp.run_image_reconstruction(proj, lat, target, tl, latent_step=5, noise_step=1,
                                 latent_abort_condition=lambda loss, i: stopped.append(i) or i == 1)
    assert stopped == [0, 1]
    mask = (torch.from_numpy(images(seed=11, channels=1)) > 0).float()
    paths, best = tlp.run_local_style_transfer(
        proj, lat, target, torch.from_numpy(images(seed=12)), mask,
        PerceptualAndStyleLoss(), style_latent_step=2, style_noise_step=2)
    assert len(paths) == 2 and torch.isfinite(best.latent).all()
    assert all(torch.isfinite(n).all() for n in best.noise)
