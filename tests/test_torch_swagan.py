"""The port's SWAGAN against the JAX package's on the CPU, and SWAGAN
through the port's GAN, discovery and dataset CLIs.

* The Haar transforms: forward and inverse within 1e-6 of the JAX upfirdn2d
  forms, the roundtrip, a constant image (all energy in ll).
* The generator at size 32, style_dim 32, n_mlp 2, its weights carried
  across with `swagan_generator_params_from_jax`: the image and every
  wavelet-space activation within 1e-4 of max|ref|, with the stored noise
  and an injected mixing index.
* The discriminator (`swagan_discriminator_params_from_jax`): logits and
  their gradient with respect to the input within 1e-4 of max|ref|.
* The D, R1, G and path-length steps against the JAX package's
  `make_train_steps` with a SWAGAN pair, fed the JAX step's own draws, as
  tests/test_torch_gan_steps.py holds StyleGAN2's: gradients within 1e-4
  (D, G) and 1e-3 (R1, path length) of each tensor's max|ref|.
* `train_stylegan_2 -s swagan` writes a SWAGAN snapshot that the dataset
  path loads; `-s 1` warns and trains StyleGAN2, as the JAX CLI does; the
  SWAGAN snapshot goes through `create_semantic_segmentation` and
  `create_dataset_for_segmentation`.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models import swagan as jax_swagan
from synthesis_in_style_tpu.updaters.stylegan2_updater import (
    StyleGAN2Config as JaxConfig,
    create_gan_train_state as jax_create_state,
    make_train_steps,
)
from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
from synthesis_in_style_tpu_torch.cli import create_semantic_segmentation as css
from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.models import stylegan2, swagan
from synthesis_in_style_tpu_torch.models.factory import (
    get_discriminator,
    get_generator,
    load_generator,
)
from synthesis_in_style_tpu_torch.ops.upfirdn2d import downsample_2d, make_kernel, upfirdn2d
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import (
    GANTrainState,
    StyleGAN2Config,
    d_reg_step,
    d_step,
    g_reg_step,
    g_step,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    load_gan_snapshot,
    strip_blur_kernels,
    swagan_discriminator_params_from_jax,
    swagan_generator_params_from_jax,
)
from synthesis_in_style_tpu_torch.utils.png import read_png
from test_torch_gan_steps import (
    REG_TOL,
    STEP_TOL,
    Capture,
    _assert_grads,
    _assert_scalar,
    _capture,
    _mix_draws,
    _native_cpu_convolutions,  # noqa: F401 (autouse fixture)
    _perturb,
)
from test_torch_gan_training import _run_cli, _write_run_inputs
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, STYLE_DIM, N_MLP, BATCH = 32, 32, 2, 4
REL_TOL = 1e-4


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("shape", [(2, 8, 6, 5), (1, 16, 16, 3)])
def test_haar_transforms_match_jax(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    dwt = swagan.haar_transform(torch.from_numpy(x))
    ref = np.asarray(jax_swagan.haar_transform(jnp.asarray(x)))
    np.testing.assert_allclose(dwt.numpy(), ref, rtol=0, atol=1e-6)
    w = np.random.RandomState(1).randn(shape[0], shape[1] // 2, shape[2] // 2,
                                       4 * shape[3]).astype(np.float32)
    iwt = swagan.inverse_haar_transform(torch.from_numpy(w))
    ref = np.asarray(jax_swagan.inverse_haar_transform(jnp.asarray(w)))
    np.testing.assert_allclose(iwt.numpy(), ref, rtol=0, atol=1e-6)
    # roundtrip, and a constant image keeps all its energy in ll
    back = swagan.inverse_haar_transform(dwt)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-6)
    const = swagan.haar_transform(torch.full(shape, 0.7))
    c = shape[-1]
    np.testing.assert_allclose(const[..., :c].numpy(), 1.4, rtol=0, atol=1e-6)
    assert float(const[..., c:].abs().max()) <= 1e-6


def test_haar_transforms_are_the_upfirdn2d_forms():
    """The block sums and differences equal upfirdn2d with the Haar kernels
    (down 2; the inverse: ll, -lh, -hl, hh, up 2, pad (1, 0, 1, 0))."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 8, 10, 3).astype(np.float32))
    kernels = swagan.haar_wavelet_kernels()
    bands = torch.cat([upfirdn2d(x, k, down=2) for k in kernels], dim=-1)
    torch.testing.assert_close(swagan.haar_transform(x), bands, rtol=0, atol=1e-6)
    signs = (1.0, -1.0, -1.0, 1.0)
    inverse = sum(upfirdn2d(part, s * k, up=2, pad=(1, 0, 1, 0))
                  for part, k, s in zip(bands.chunk(4, dim=-1), kernels, signs))
    torch.testing.assert_close(swagan.inverse_haar_transform(bands), inverse, rtol=0,
                               atol=1e-6)


def test_downsample_2d_matches_jax():
    from synthesis_in_style_tpu.ops import downsample_2d as jax_downsample, make_kernel as jmk

    x = np.random.RandomState(3).randn(2, 12, 10, 3).astype(np.float32)
    got = downsample_2d(torch.from_numpy(x), make_kernel([1, 3, 3, 1]), 2)
    ref = jax_downsample(jnp.asarray(x), jmk([1, 3, 3, 1]), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _generators():
    jgen = jax_swagan.Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    variables = jax.jit(jgen.init)({"params": jax.random.PRNGKey(0),
                                    "noise": jax.random.PRNGKey(1)},
                                   [jnp.zeros((1, STYLE_DIM))])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": _perturb(variables["params"]), "noises": variables["noises"]}
    gen = swagan.Generator(SIZE, STYLE_DIM, N_MLP)
    gen.load_state_dict(swagan_generator_params_from_jax(variables), strict=True)
    return jgen, variables, gen.eval()


def test_generator_matches_jax():
    jgen, variables, gen = _generators()
    assert (gen.n_latent, gen.num_layers) == (jgen.n_latent, jgen.num_layers) == (6, 5)
    assert [tuple(b.shape) for b in gen.noises.nhwc()] == list(jgen.noise_shapes())
    rs = np.random.RandomState(4)
    z1, z2 = (rs.randn(BATCH, STYLE_DIM).astype(np.float32) for _ in range(2))
    image, acts = jax.jit(lambda v, a, b: jgen.apply(
        v, [a, b], inject_index=3, randomize_noise=False,
        return_intermediate_activations=True))(variables, jnp.asarray(z1), jnp.asarray(z2))
    with torch.no_grad():
        got, got_acts = gen([torch.from_numpy(z1), torch.from_numpy(z2)], inject_index=3,
                            randomize_noise=False, return_intermediate_activations=True)
    assert got.shape == (BATCH, SIZE, SIZE, 3)
    assert _rel_err(got, image) <= REL_TOL
    assert sorted(got_acts) == sorted(acts) == list(range(gen.num_layers + 1))
    for key, ref in acts.items():  # wavelet space: 4x4 to SIZE/2
        assert _rel_err(got_acts[key], ref) <= REL_TOL, key
    assert got_acts[gen.num_layers].shape[1] == SIZE // 2


@functools.lru_cache(maxsize=None)
def _discriminators():
    jdisc = jax_swagan.Discriminator(size=SIZE)
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(5), jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    params = _perturb(jax.tree_util.tree_map(np.asarray, params))
    disc = swagan.Discriminator(SIZE)
    disc.load_state_dict(swagan_discriminator_params_from_jax(params), strict=True)
    return jdisc, params, disc


def test_discriminator_logits_and_input_gradient_match_jax():
    jdisc, params, disc = _discriminators()
    # an input whose pre-activations lie clear of float32 rounding of 0 (as
    # in tests/test_torch_gan_steps.py: a LeakyReLU that takes the other
    # branch on one side moves the gradient upstream of it by 0.8 g)
    x = np.random.RandomState(7).randn(BATCH, SIZE, SIZE, 3).astype(np.float32)

    @jax.jit
    def ref_fn(img):
        logits, vjp = jax.vjp(lambda i: jdisc.apply({"params": params}, i), img)
        return logits, vjp(jnp.ones_like(logits))[0]

    logits, ref_grad = ref_fn(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = disc(xt)
    (grad,) = torch.autograd.grad(got.sum(), xt)
    assert _rel_err(got, logits) <= REL_TOL
    assert _rel_err(grad, ref_grad) <= REL_TOL


def test_reference_layout_loads_with_its_fixed_buffers():
    """A reference SWAGAN state dict carries its Haar and FIR buffers
    (`dwt.ll`, `from_rgbs.1.downsample.kernel`, ...): they are dropped."""
    _, _, disc = _discriminators()
    sd = dict(disc.state_dict())
    sd.update({"dwt.ll": torch.ones(1, 1, 2, 2), "from_rgbs.1.iwt.hh": torch.ones(1, 1, 2, 2),
               "from_rgbs.1.downsample.kernel": torch.ones(4, 4)})
    fresh = swagan.Discriminator(SIZE)
    fresh.load_state_dict(strip_blur_kernels(sd), strict=True)


@functools.lru_cache(maxsize=None)
def _step_setup():
    jgen = jax_swagan.Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    jdisc = jax_swagan.Discriminator(size=SIZE)
    tx = _capture()
    state = jax.jit(lambda k: jax_create_state(jgen, jdisc, k, SIZE, tx, tx))(
        jax.random.PRNGKey(0))
    state = state.replace(g_params=_perturb(state.g_params), d_params=_perturb(state.d_params),
                          mean_path_length=jnp.asarray(0.3, jnp.float32))
    state = jax.tree_util.tree_map(np.asarray, state)
    cfg = JaxConfig(freeze_noise_layers=tuple(range(jgen.num_layers)))
    steps = make_train_steps(jgen, jdisc, tx, tx, cfg, BATCH, donate=False)
    real = np.random.RandomState(1).randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    return jgen, state, steps, real


def _port_state(state):
    gen = swagan.Generator(SIZE, STYLE_DIM, N_MLP)
    gen.load_state_dict(swagan_generator_params_from_jax({"params": state.g_params,
                                                          "noises": state.g_noises}))
    disc = swagan.Discriminator(SIZE)
    disc.load_state_dict(swagan_discriminator_params_from_jax(state.d_params))
    return GANTrainState(generator=gen, discriminator=disc, g_ema=gen,
                         g_optimizer=Capture(gen), d_optimizer=Capture(disc),
                         mean_path_length=torch.tensor(float(state.mean_path_length)))


def _port_cfg(jgen):
    return StyleGAN2Config(freeze_noise_layers=tuple(range(jgen.num_layers)))


def _d_grads(grads):
    return swagan_discriminator_params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _g_grads(grads):
    return swagan_generator_params_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})


@pytest.mark.parametrize("step", ["d_step", "d_reg_step", "g_step", "g_reg_step"])
def test_training_steps_match_jax(step):
    jgen, state, steps, real = _step_setup()
    port = _port_state(state)
    cfg = _port_cfg(jgen)
    if step == "d_step":
        rng = jax.random.PRNGKey(11)
        new_state, m = steps[step](state, jnp.asarray(real), rng)
        draws = _mix_draws(BATCH, jgen, port.generator, jax.random.split(rng, 4)[:3])
        pm = d_step(port, cfg, torch.from_numpy(real), draws)
        keys, tol, grads, ref = (("discriminator_loss", "real_score", "fake_score"), STEP_TOL,
                                 port.d_optimizer.grads, _d_grads(new_state.d_opt))
    elif step == "d_reg_step":
        new_state, m = steps[step](state, jnp.asarray(real))
        pm = d_reg_step(port, cfg, torch.from_numpy(real))
        keys, tol, grads, ref = (("r1_penalty",), REG_TOL, port.d_optimizer.grads,
                                 _d_grads(new_state.d_opt))
    elif step == "g_step":
        rng = jax.random.PRNGKey(17)
        new_state, m = steps[step](state, rng)
        draws = _mix_draws(BATCH, jgen, port.generator, jax.random.split(rng, 4)[:3])
        pm = g_step(port, cfg, draws)
        keys, tol, grads, ref = (("generator_loss",), STEP_TOL, port.g_optimizer.grads,
                                 _g_grads(new_state.g_opt))
    else:
        rng = jax.random.PRNGKey(13)
        new_state, m = steps[step](state, rng)
        path_batch = BATCH // 2
        kz1, kz2, kmix, _, kpl = jax.random.split(rng, 5)
        draws = _mix_draws(path_batch, jgen, port.generator, (kz1, kz2, kmix))
        pl_noise = jax.random.normal(kpl, (path_batch, SIZE, SIZE, 3)) / math.sqrt(SIZE * SIZE)
        pm = g_reg_step(port, cfg, draws, torch.from_numpy(np.array(pl_noise)))
        keys, tol, grads, ref = (("path_loss", "path_length", "mean_path_length"), REG_TOL,
                                 port.g_optimizer.grads, _g_grads(new_state.g_opt))
    for key in keys:
        _assert_scalar(pm[key], m[key], tol, key)
    _assert_grads(grads, ref, tol, step)


def test_factory_dispatches_on_the_variant():
    config = {"image_size": 16, "latent_size": 32, "n_mlp": 2, "stylegan_variant": "swagan"}
    gen = get_generator(config)
    assert isinstance(gen, swagan.Generator) and gen.n_latent == 4
    assert isinstance(get_discriminator(config), swagan.Discriminator)
    assert type(get_generator(config, variant=2)) is stylegan2.Generator
    from synthesis_in_style_tpu_torch.models.stylegan1 import StyledGenerator

    assert type(get_generator(config, variant=1)) is StyledGenerator
    with pytest.raises(NotImplementedError, match="not supported"):
        get_generator(config, variant="3")


def _float32_run_inputs(tmp_path, **changes):
    """The GAN CLI test's inputs, trained in float32 (bfloat16 convolutions
    are slow on the CPU)."""
    data = _write_run_inputs(tmp_path, n_images=4)
    config = json.loads((data / "config.json").read_text())
    config.update(compute_dtype=None, **changes)
    (data / "config.json").write_text(json.dumps(config))
    return data


def _swagan_run(tmp_path):
    data = _float32_run_inputs(tmp_path, image_size=SIZE, freeze_stochastic_noise_layers=True)
    trainer = _run_cli(data, tmp_path / "logs", "-s", "swagan")
    (run,) = (tmp_path / "logs" / "stylegan2").iterdir()
    return trainer, run


def test_cli_trains_swagan_and_its_snapshot_feeds_the_dataset_path(tmp_path):
    trainer, run = _swagan_run(tmp_path)
    state = trainer.updater.state
    assert isinstance(state.generator, swagan.Generator)
    assert isinstance(state.discriminator, swagan.Discriminator)
    assert trainer.updater.cfg.freeze_noise_layers == tuple(range(state.generator.num_layers))
    log = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    assert all(math.isfinite(e["train/discriminator_loss"]) for e in log)
    snap_path = run / "checkpoints" / "iter_00000002.pt"
    snap = load_gan_snapshot(snap_path)
    assert snap["g_ema"]["to_rgb1.bias"].shape == (1, 12, 1, 1)
    config = load_config_from_checkpoint(snap_path)
    assert config["stylegan_variant"] == "swagan"
    gen = load_generator(snap_path, config, device="cpu")
    assert isinstance(gen, swagan.Generator)
    for name, value in gen.state_dict().items():
        torch.testing.assert_close(value, snap["g_ema"][name], rtol=0, atol=0)

    # discovery over the wavelet-space layers, then labelled synthesis
    css.main(css.build_parser().parse_args(
        [str(snap_path), "-n", "8", "-b", "4", "-c", "3", "4", "-d", "cpu"]))
    sem = run / "semantic_segmentation"
    with np.load(sem / "catalogs" / "3.npz") as catalog:
        layers = sorted({name.split("_", 1)[1] for name in catalog.files})
    assert layers == [str(i) for i in range(gen.num_layers + 1)]
    classes = ["background", "printed_text", "handwritten_text"]
    coarse, fine = ["2", "3"], ["4", "5"]  # 8px and 16px in wavelet space
    (sem / "merged_classes_3.json").write_text(json.dumps(
        {layer: {str(c): classes[c] for c in range(3)} for layer in coarse + fine}))
    creation = {"class_to_color_map": {"background": "#000000", "printed_text": "#0000FF",
                                       "handwritten_text": "#FF0000"},
                "keys_for_class_determination": coarse,
                "keys_for_finegrained_segmentation": fine, "keys_to_merge": {},
                "segmenter_type": "black_white_handwritten_printed",
                "only_keep_overlapping": False, "min_class_contour_area": 2, "seed": 1}
    creation_path = tmp_path / "creation.json"
    creation_path.write_text(json.dumps(creation))
    cds.main(cds.build_parser().parse_args(
        [str(snap_path), str(creation_path), "-b", "4", "-n", "8", "--num-clusters", "3",
         "-d", "cpu", "--device-contours"]))
    pngs = sorted((run / "generated_images").glob("**/*.png"))
    assert pngs
    for png in pngs:
        assert read_png(png).shape == (SIZE, 2 * SIZE, 3)


def test_cli_stylegan_variant_1_warns_and_trains_stylegan2(tmp_path):
    data = _float32_run_inputs(tmp_path)
    with pytest.warns(UserWarning, match="falls back to StyleGAN2"):
        trainer = _run_cli(data, tmp_path / "logs", "-s", "1")
    state = trainer.updater.state
    assert type(state.generator) is stylegan2.Generator
    assert type(state.discriminator) is stylegan2.Discriminator
    assert trainer.updater.iteration == 2
