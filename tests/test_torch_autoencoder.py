"""The port's autoencoders against the JAX package's on the CPU (32px,
latent 32, n_mlp 2, channel multiplier 1; narrow encoders): the six
compositions, the factory, `load_autoencoder_or_generator`, the snapshot
round trip and JAX `.npz` conversion, autoencoder training steps, the
autoencoder datasets, and the updater under the Trainer.

Tolerances: forwards within 1e-4 of the reference's max |value|;
parameters after a step within 1e-4 of the reference's max |parameter|.
Where a JAX composition draws noise from its own PRNG stream, the test
draws the noise with numpy, hands it to the port composition (its
`draw_noise` / `draw_dropout`) and to the JAX decoder, and compares the
images."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthesis_in_style_tpu.models import autoencoder as jae
from synthesis_in_style_tpu.models import encoder as jenc
from synthesis_in_style_tpu.models.stylegan2 import Discriminator as JaxDiscriminator
from synthesis_in_style_tpu.utils.checkpoint import save_pytree_npz
from synthesis_in_style_tpu_torch.models import autoencoder as tae
from synthesis_in_style_tpu_torch.models import encoder as tenc
from synthesis_in_style_tpu_torch.models import factory
from synthesis_in_style_tpu_torch.models.stylegan1 import StyledGenerator
from synthesis_in_style_tpu_torch.models.stylegan2 import Discriminator, Generator
from synthesis_in_style_tpu_torch.updaters import autoencoder_updater as tupd
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    autoencoder_params_from_jax,
    discriminator_params_from_jax,
    load_autoencoder_snapshot,
    save_autoencoder_snapshot,
)

from tests.torch_autoencoder_fixtures import (
    LATENT,
    SCM,
    SGD,
    SIZE,
    assert_close,
    assert_updates,
    images,
    init_jax,
    jax_decoder,
    load_port,
    lpips_pair,
    numpy_tree,
    port_decoder,
    remove_files,
    snapshot,
    stylegan_autoencoders,
    wplus_pair,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _jax_decoder_fn(style_dim: int):
    dec = jax_decoder(style_dim)
    return jax.jit(lambda v, latent, noise: dec.apply(
        v, [latent], input_is_latent=True, noise=noise, randomize_noise=False)[0])


def _jax_decode(variables, latent, noise, style_dim=LATENT):
    """The JAX decoder of a composition's variables on w+ and given noise."""
    dec = {"params": variables["params"]["decoder"], "noises": variables["noises"]["decoder"]}
    return np.asarray(_jax_decoder_fn(style_dim)(
        dec, jnp.asarray(latent), [jnp.asarray(n) for n in noise]))


def _jax_encode(module, variables, x):
    return module.apply(variables, jnp.asarray(x), train=False, method="encode")


def _noise(decoder, batch, seed, start=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(batch, *shape[1:]).astype(np.float32)
            for shape in decoder.noise_shapes()[start:]]


def test_stylegan_autoencoder_matches_jax():
    jmod, variables, tmod = stylegan_autoencoders()
    x = images()
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
        latents = tmod.encode(torch.from_numpy(x))
    assert_close(got, ref, "image")
    assert tae.is_wplus(latents)
    # without the predicted noise the decode draws fresh maps (injected here)
    noise = _noise(tmod.decoder, 2, 1)
    tmod.draw_noise = lambda batch, like, generator, start=0: [torch.from_numpy(n)
                                                              for n in noise]
    tmod.use_generated_noise = False
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    ref_latent = np.asarray(_jax_encode(jmod, variables, x).latent)
    assert_close(got, _jax_decode(variables, ref_latent, noise), "image, drawn noise")


def test_dropout_autoencoder_matches_jax():
    jenc_, tenc_ = wplus_pair()
    jmod = jae.DropoutStyleganAutoencoder(encoder=jenc_, decoder=jax_decoder())
    variables = init_jax(jmod, jnp.zeros((1, SIZE, SIZE, 3)))
    tmod = load_port(tae.DropoutStyleganAutoencoder(tenc_, port_decoder()), variables).eval()
    x = images()
    # ratio 0: every predicted map is kept, so the JAX forward is deterministic
    tmod.dropout_ratio = 0.0
    ref = jax.jit(lambda v, x: jae.DropoutStyleganAutoencoder(
        encoder=jenc_, decoder=jax_decoder(), dropout_ratio=0.0).apply(
            v, x, train=False, rngs={"dropout": jax.random.PRNGKey(1)}))(
                variables, jnp.asarray(x))
    with torch.no_grad():
        assert_close(tmod(torch.from_numpy(x)), ref, "image, ratio 0")
    # injected draws: maps 0, 2, 3 replaced
    latents = _jax_encode(jmod, variables, x)
    random = _noise(tmod.decoder, 2, 2)
    keep = [i not in (0, 2, 3) for i in range(len(random))]
    tmod.draw_dropout = lambda noise, generator: (
        [torch.tensor(k) for k in keep], [torch.from_numpy(r) for r in random])
    mixed = [np.asarray(p) if k else r for k, p, r in zip(keep, latents.noise, random)]
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert_close(got, _jax_decode(variables, np.asarray(latents.latent), mixed), "image, mixed")


def test_code_autoencoder_matches_jax():
    code = 8
    jmod = jae.CodeStyleganAutoencoder(encoder=jenc.WCodeEncoder(code, SIZE, LATENT, 3, SCM),
                                       decoder=jax_decoder(LATENT + code))
    variables = init_jax(jmod, jnp.zeros((1, SIZE, SIZE, 3)))
    tmod = load_port(tae.CodeStyleganAutoencoder(tenc.WCodeEncoder(code, SIZE, LATENT, 3, SCM),
                                                 port_decoder(LATENT + code)), variables).eval()
    x = images()
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        assert_close(tmod(torch.from_numpy(x)), ref, "image")


def test_content_and_style_autoencoder_matches_jax():
    jenc_, tenc_ = wplus_pair(in_ch=6)
    jmod = jae.ContentAndStyleStyleganAutoencoder(encoder=jenc_, decoder=jax_decoder())
    z = jnp.zeros((1, SIZE, SIZE, 3))
    variables = init_jax(jmod, z, z)
    tmod = load_port(tae.ContentAndStyleStyleganAutoencoder(tenc_, port_decoder()),
                     variables).eval()
    content, style = images(seed=1), images(seed=2)
    ref = jax.jit(lambda v, a, b: jmod.apply(v, a, b, train=False))(
        variables, jnp.asarray(content), jnp.asarray(style))
    with torch.no_grad():
        got = tmod(torch.from_numpy(content), torch.from_numpy(style))
    assert_close(got, ref, "image")


@pytest.mark.parametrize("extend_with_random", [False, True])
def test_superresolution_autoencoder_matches_jax(extend_with_random):
    """A 16px encoder in front of the 32px decoder: box-averaged input, the
    missing noise maps upsampled (or drawn, injected here), the missing w+
    rows repeated."""
    scm16 = {16: 32, 8: 32, 4: 32}
    jmod = jae.SuperResolutionStyleganAutoencoder(
        encoder=jenc.WPlusEncoder(16, LATENT, 3, scm16), decoder=jax_decoder(),
        extend_noise_with_random=extend_with_random)
    variables = init_jax(jmod, jnp.zeros((1, SIZE, SIZE, 3)))
    tmod = load_port(tae.SuperResolutionStyleganAutoencoder(
        tenc.WPlusEncoder(16, LATENT, 3, scm16), port_decoder(),
        extend_noise_with_random=extend_with_random), variables).eval()
    x = images()
    if not extend_with_random:
        ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(x))
        with torch.no_grad():
            assert_close(tmod(torch.from_numpy(x)), ref, "image, upsampled noise")
        return
    small = x.reshape(2, 16, 2, 16, 2, 3).mean(axis=(2, 4))
    latents = jmod.encoder.apply({"params": variables["params"]["encoder"],
                                  "batch_stats": variables["batch_stats"]["encoder"]},
                                 jnp.asarray(small))
    drawn = _noise(tmod.decoder, 2, 3, start=len(latents.noise))
    tmod.draw_noise = lambda batch, like, generator, start=0: [torch.from_numpy(n)
                                                              for n in drawn]
    latent = np.asarray(latents.latent)
    latent = np.concatenate([latent, np.repeat(latent[:, -1:], 8 - latent.shape[1], 1)], 1)
    noise = [np.asarray(n) for n in latents.noise] + drawn
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert_close(got, _jax_decode(variables, latent, noise), "image, drawn noise")


def _two_stem(update_latent=True, update_noise=True):
    jmod = jae.TwoStemStyleganAutoencoder(
        latent_encoder=jenc.WPlusNoNoiseEncoder(SIZE, LATENT, 3, SCM),
        noise_encoder=jenc.NoiseEncoder(SIZE, LATENT, 3, SCM), decoder=jax_decoder(),
        update_latent=update_latent, update_noise=update_noise)
    tmod = tae.TwoStemStyleganAutoencoder(
        tenc.WPlusNoNoiseEncoder(SIZE, LATENT, 3, SCM), tenc.NoiseEncoder(SIZE, LATENT, 3, SCM),
        port_decoder(), update_latent=update_latent, update_noise=update_noise)
    return jmod, tmod


def test_two_stem_autoencoder_matches_jax():
    jmod, tmod = _two_stem()
    variables = init_jax(jmod, jnp.zeros((1, SIZE, SIZE, 3)))
    tmod = load_port(tmod, variables).eval()
    x = images()
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        assert_close(tmod(torch.from_numpy(x)), ref, "image")
    # update_latent=False: the latent stem gets no gradient; update_noise=False:
    # fresh noise (injected) and the noise stem is never run
    tmod.update_latent, tmod.update_noise = False, True
    tmod(torch.from_numpy(x)).square().mean().backward()
    assert all(p.grad is None for p in tmod.latent_encoder.parameters())
    assert any(p.grad is not None for p in tmod.noise_encoder.parameters())
    tmod.zero_grad(set_to_none=True)
    tmod.update_latent, tmod.update_noise = True, False
    drawn = _noise(tmod.decoder, 2, 4)
    tmod.draw_noise = lambda batch, like, generator, start=0: [torch.from_numpy(n)
                                                              for n in drawn]
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    latent = np.asarray(jmod.latent_encoder.apply(
        {"params": variables["params"]["latent_encoder"],
         "batch_stats": variables["batch_stats"]["latent_encoder"]}, jnp.asarray(x)).latent)
    assert_close(got, _jax_decode(variables, latent, drawn), "image, drawn noise")
    with pytest.raises(AssertionError):
        tmod.update_latent = False
        tmod(torch.from_numpy(x))


def test_factory_dispatch():
    base = {"image_size": SIZE, "latent_size": LATENT, "n_mlp": 2, "channel_multiplier": 1}
    assert factory.autoencoder_type_from_config(base) == "wplus"
    assert factory.autoencoder_type_from_config({**base, "dropout_autoencoder": True}) == "dropout"
    assert factory.autoencoder_type_from_config(
        {**base, "two_stem": True, "dropout_autoencoder": True}) == "two_stem"
    kinds = {"wplus": (tae.StyleganAutoencoder, tenc.UNetLikeEncoder),
             "dropout": (tae.DropoutStyleganAutoencoder, tenc.UNetLikeEncoder),
             "wplus_resnet_noise": (tae.StyleganAutoencoder, tenc.UNetLikeEncoder),
             "content_and_style": (tae.ContentAndStyleStyleganAutoencoder,
                                   tenc.UNetLikeEncoder),
             "superresolution": (tae.SuperResolutionStyleganAutoencoder, tenc.UNetLikeEncoder),
             "two_stem": (tae.TwoStemStyleganAutoencoder, tenc.UNetLikeEncoder)}
    for kind, (cls, enc_cls) in kinds.items():
        ae = factory.get_autoencoder(base, kind)
        assert type(ae) is cls, kind
        encoder = ae.latent_encoder if kind == "two_stem" else ae.encoder
        assert isinstance(encoder, enc_cls) and isinstance(ae.decoder, Generator), kind
        assert all(not n.startswith("decoder.") for n, _ in ae.named_parameters()
                   if any(p is _ for p in ae.encoder_parameters()))
        assert len(ae.encoder_parameters()) + len(list(ae.decoder.parameters())) == \
            len(list(ae.parameters()))
    assert factory.get_autoencoder(base, "content_and_style").encoder.resnet_blocks[0] \
        .conv1.in_channels == 6
    assert isinstance(factory.get_autoencoder({**base, "w_only": True}).encoder,
                      tenc.WWPlusEncoder)
    assert isinstance(factory.get_autoencoder({**base, "w_only": True}, "two_stem")
                      .latent_encoder, tenc.WNoNoiseEncoder)
    ae = factory.get_autoencoder({**base, "stylegan_variant": 1})
    assert isinstance(ae.decoder, StyledGenerator) and ae.encoder.stylegan_variant == 1
    with pytest.raises(NotImplementedError):
        factory.get_autoencoder(base, "nope")


def _config_dir(run, config):
    (run / "config").mkdir(parents=True, exist_ok=True)
    (run / "config" / "config.json").write_text(json.dumps(config))
    (run / "checkpoints").mkdir(exist_ok=True)


def test_snapshot_round_trip_and_loading(tmp_path):
    """save -> load_autoencoder_snapshot -> load_autoencoder_or_generator,
    and a generator-only checkpoint loads the generator."""
    config = {"image_size": SIZE, "latent_size": LATENT, "n_mlp": 2, "channel_multiplier": 1}
    _config_dir(tmp_path, config)
    ae = factory.get_autoencoder(config)
    ae.encoder.init_weights(torch.Generator().manual_seed(0))
    ae.decoder.init_weights(torch.Generator().manual_seed(1))
    path = tmp_path / "checkpoints" / "ae.pt"
    save_autoencoder_snapshot(path, ae, iteration=3)
    snap = load_autoencoder_snapshot(path)
    assert snap["iteration"] == 3
    assert sorted(snap["g_ema"]) == sorted(ae.decoder.state_dict())
    loaded = factory.load_autoencoder_or_generator(path, config, device="cpu")
    assert isinstance(loaded, tae.StyleganAutoencoder) and not loaded.training
    for k, v in ae.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    gen_path = tmp_path / "checkpoints" / "g.pt"
    torch.save({"g_ema": ae.decoder.state_dict()}, gen_path)
    assert load_autoencoder_snapshot(gen_path) is None
    gen = factory.load_autoencoder_or_generator(gen_path, config, device="cpu")
    assert isinstance(gen, Generator) and not hasattr(gen, "encoder")
    remove_files(path, gen_path)


def test_jax_npz_conversion(tmp_path):
    """An `autoencoder` tree written by the JAX package's save_pytree_npz
    loads into the port's composition and decodes as the JAX one does."""
    jmod, variables, tmod = stylegan_autoencoders()
    config = {"image_size": SIZE, "latent_size": LATENT, "n_mlp": 2, "channel_multiplier": 1}
    _config_dir(tmp_path, config)
    path = tmp_path / "checkpoints" / "ae.npz"
    save_pytree_npz(path, {"autoencoder": variables})
    snap = load_autoencoder_snapshot(path)
    want = autoencoder_params_from_jax(variables)
    assert sorted(snap["autoencoder"]) == sorted(want)
    assert sorted(snap["g_ema"]) == sorted(k[len("decoder."):] for k in want
                                           if k.startswith("decoder."))
    # the narrow test encoder, not the factory's: load into a module of its shapes
    loaded = tae.StyleganAutoencoder(wplus_pair()[1], port_decoder())
    loaded.decoder.init_weights(torch.Generator().manual_seed(0))
    factory.load_autoencoder_state(loaded, snap["autoencoder"])
    loaded.eval()
    x = images(seed=5)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        assert_close(loaded(torch.from_numpy(x)), ref, "image from npz")
    remove_files(path)


def test_autoencoder_steps_match_jax():
    """Two reconstruction steps (MSE + LPIPS, Adam behind a global-norm
    clip over the encoder's gradients) against the JAX steps: the losses,
    the encoder's parameters and statistics, the decoder bitwise unchanged.
    Adam runs with eps 1: its first steps with the default eps are
    lr * sign(g), so an element whose gradient is within float32 rounding of
    0 (a LeakyReLU tie in the decoder, a skip-conv bias in front of a
    train-mode BatchNorm) would move by lr either way; with eps 1 the update
    follows the gradient, whose agreement (~1e-3 of max |g|) is what is
    held. Each update is held within 1e-2 of the largest update of its
    group (the parameters, the BatchNorm statistics)."""
    jmod, variables, tmod = stylegan_autoencoders()
    jl, tl = lpips_pair("alex")
    lr = 1e-3
    base_tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr, eps=1.0))
    from synthesis_in_style_tpu.updaters.autoencoder_updater import (
        create_ae_train_state,
        make_autoencoder_train_step,
    )

    state, tx = create_ae_train_state(jmod, jax.random.PRNGKey(0), SIZE, base_tx)

    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          noises=variables["noises"], opt_state=tx.init(variables["params"]))
    jstep = make_autoencoder_train_step(jmod, tx, lpips=jl, donate=False)
    tstate = tupd.create_ae_train_state(tmod, tupd.adam_optimizer(lr, eps=1.0, max_norm=1.0))
    before = snapshot(tmod)
    tstep = tupd.make_autoencoder_train_step(lpips=tl)
    batch = {"input_image": images(seed=7), "output_image": images(seed=8)}
    for _ in range(2):
        state, jlosses = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(0))
        tlosses = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("reconstruction_loss", "perceptual_loss", "autoencoder_loss"):
            assert_close(tlosses[key], jlosses[key], key)
    assert tstate.step == 2
    want = autoencoder_params_from_jax({"params": numpy_tree(state.params),
                                        "batch_stats": numpy_tree(state.batch_stats),
                                        "noises": variables["noises"]})
    got = tmod.state_dict()
    floats = [k for k in want if k.startswith("encoder.") and want[k].is_floating_point()]
    scale = max(float(want[k].abs().max()) for k in floats)
    for key in floats:
        assert_close(got[key], want[key].numpy(), key, scale=scale)
    params = {n for n, _ in tmod.named_parameters()}
    assert_updates(got, before, want, [k for k in floats if k in params], "encoder")
    assert_updates(got, before, want, [k for k in floats if k not in params], "statistics")
    for key, value in before.items():
        if key.startswith("decoder."):
            assert torch.equal(got[key], value), key
    assert not any(p.requires_grad for p in tmod.decoder.parameters())


def test_autoencoder_gan_steps_match_jax():
    """One D, R1 and G step of the autoencoder-plus-discriminator training
    (SGD on both sides, so the parameters follow the gradients linearly)
    against the JAX steps: the parameters, and the updates of D, the
    encoder and its statistics within 1e-2 of their group's largest
    update; the decoder bitwise unchanged. The updater runs R1 on
    iterations 0 and 16 of 17."""
    from synthesis_in_style_tpu.updaters.autoencoder_updater import (
        create_ae_train_state,
        make_autoencoder_gan_steps,
    )

    jmod, variables, tmod = stylegan_autoencoders()
    jdisc = JaxDiscriminator(size=SIZE, channel_multiplier=1)
    lr = 1e-3
    state, tx = create_ae_train_state(jmod, jax.random.PRNGKey(0), SIZE, optax.sgd(lr),
                                      discriminator=jdisc, d_tx=optax.sgd(lr))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          noises=variables["noises"])
    steps = make_autoencoder_gan_steps(jmod, jdisc, tx, optax.sgd(lr), donate=False)
    disc = Discriminator(SIZE, channel_multiplier=1)
    disc.load_state_dict(discriminator_params_from_jax(numpy_tree(state.d_params)), strict=True)
    tstate = tupd.create_ae_train_state(tmod, lambda p: SGD(p, lr), discriminator=disc)
    tsteps = tupd.make_autoencoder_gan_steps()
    before, d_before = snapshot(tmod), snapshot(disc)
    batch = {"input_image": images(seed=9), "output_image": images(seed=10)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, jd = steps["d_step"](state, jbatch, jax.random.PRNGKey(0))
    td = tsteps["d_step"](tstate, tbatch)
    state, jr = steps["d_reg_step"](state, jbatch)
    tr = tsteps["d_reg_step"](tstate, tbatch)
    state, jg = steps["g_step"](state, jbatch, jax.random.PRNGKey(0))
    tg = tsteps["g_step"](tstate, tbatch)
    for key in ("loss", "real_score", "fake_score"):
        assert_close(td[key], jd[key], f"d {key}")
    assert_close(tr["gradient_penalty"], jr["gradient_penalty"], "r1", rel=1e-3)
    for key in ("autoencoder_loss", "discriminator_loss", "loss"):
        assert_close(tg[key], jg[key], f"g {key}")
    want_d = discriminator_params_from_jax(numpy_tree(state.d_params))
    scale = max(float(v.abs().max()) for v in want_d.values())
    for key, value in want_d.items():
        assert_close(disc.state_dict()[key], value.numpy(), f"D {key}", scale=scale)
    assert_updates(disc.state_dict(), d_before, want_d, want_d, "D")
    want = autoencoder_params_from_jax({"params": numpy_tree(state.params),
                                        "batch_stats": numpy_tree(state.batch_stats),
                                        "noises": variables["noises"]})
    floats = [k for k in want if k.startswith("encoder.") and want[k].is_floating_point()]
    scale = max(float(want[k].abs().max()) for k in floats)
    got = tmod.state_dict()
    for key in floats:
        assert_close(got[key], want[key].numpy(), key, scale=scale)
    # the encoder's parameters and its BatchNorm statistics, each group held
    # to its own largest update; the decoder bitwise unchanged
    params = {n for n, _ in tmod.named_parameters()}
    assert_updates(got, before, want, [k for k in floats if k in params], "encoder")
    assert_updates(got, before, want, [k for k in floats if k not in params], "statistics")
    for key, value in before.items():
        if key.startswith("decoder."):
            assert torch.equal(got[key], value), key

    fired = []
    steps_stub = {"d_step": lambda s, b, g: {}, "g_step": lambda s, b, g: {},
                  "d_reg_step": lambda s, b: fired.append(updater.iteration) or {}}
    batches = iter([tbatch] * 17)
    updater = tupd.AutoencoderDiscriminatorUpdater(steps_stub, tstate, {"images": batches},
                                                   device="cpu")
    for _ in range(17):
        updater.update()
    assert fired == [0, 16]


def _write_pages(directory, n=4, seed=0):
    from synthesis_in_style_tpu_torch.utils.png import write_png

    directory.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    names = [f"{i}.png" for i in range(n)]
    for name in names:
        write_png(directory / name, rs.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8))
    (directory / "images.json").write_text(json.dumps(names))
    return directory / "images.json"


@pytest.mark.parametrize("kind", ["AutoencoderDataset", "DenoisingAutoencoderDataset",
                                  "BlackAndWhiteDenoisingAutoencoderDataset"])
def test_autoencoder_datasets_match_jax(tmp_path, kind):
    """The same pairs as the JAX datasets (images at the target size, so
    neither side resizes): the same numpy draws from the same seeded
    stream, PIL's grayscale conversion on both sides."""
    from synthesis_in_style_tpu.data import autoencoder_dataset as jds
    from synthesis_in_style_tpu_torch.data import autoencoder_dataset as tds

    listing = _write_pages(tmp_path / "pages")
    ours = getattr(tds, kind)(listing, root=listing.parent, image_size=SIZE, seed=3)
    theirs = getattr(jds, kind)(listing, root=listing.parent, image_size=SIZE, seed=3)
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        for key in ("input_image", "output_image"):
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=f"{i} {key}")
    if kind != "AutoencoderDataset":
        assert not np.array_equal(ours[0]["input_image"].numpy(), ours[0]["output_image"].numpy())


def test_autoencoder_updater_trains_the_encoder_only(tmp_path):
    """AutoencoderUpdater under the Trainer for 3 iterations on denoising
    pairs: losses reported each iteration, the encoder moved, the decoder
    (parameters and noise buffers) bitwise unchanged."""
    from synthesis_in_style_tpu_torch.core.trainer import Trainer
    from synthesis_in_style_tpu_torch.data.autoencoder_dataset import DenoisingAutoencoderDataset
    from synthesis_in_style_tpu_torch.data.loader import EpochStream, make_loader

    listing = _write_pages(tmp_path / "pages", n=4, seed=1)
    ds = DenoisingAutoencoderDataset(listing, root=listing.parent, image_size=SIZE)
    stream = EpochStream(make_loader(ds, 2, shuffle=True, drop_last=True, num_workers=0))
    ae = tae.StyleganAutoencoder(tenc.WPlusEncoder(SIZE, LATENT, 3, SCM), port_decoder())
    ae.encoder.init_weights(torch.Generator().manual_seed(0))
    ae.decoder.init_weights(torch.Generator().manual_seed(1))
    before = snapshot(ae)
    state = tupd.create_ae_train_state(ae, tupd.adam_optimizer(1e-3, max_norm=1.0))
    updater = tupd.AutoencoderUpdater(tupd.make_autoencoder_train_step(), state,
                                      {"images": stream}, device="cpu")
    seen = []

    class Record:
        priority, trigger = 100, None

        def initialize(self, trainer):
            pass

        def finalize(self, trainer):
            pass

        def __call__(self, trainer):
            seen.append(trainer.reporter.peek("loss/autoencoder_loss"))

    trainer = Trainer(updater, (3, "iteration")).extend(Record())
    trainer.train()
    assert state.step == 3 and len(seen) == 3 and all(np.isfinite(v) for v in seen)
    after = ae.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("decoder."))
    assert any(not torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("encoder.") and v.is_floating_point())
