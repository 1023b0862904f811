"""The port's adversarial autoencoder training against the JAX package's on
the CPU (32px, latent 32, n_mlp 2, channel multiplier 1; narrow encoders):
`create_mask`, one D, R1 and G step (SGD on both sides, so the parameters
follow the gradients linearly), the iterations on which R1 fires, and the
CLI end to end on the CPU (16px, 2 iterations; StyleGAN2 and
stylegan_variant 1). Tolerances: metrics and forwards within 1e-4 of the
reference (R1's penalty 1e-3: a sum of squared input gradients);
parameters after a step within 1e-4 of the largest reference
parameter, and each update (after - before) within 1e-2 of the largest
reference update of its group (D; the generation autoencoder's encoder,
its decoder, its BatchNorm statistics): a parameter that did not move, or
moved along a wrong gradient, fails there. The reconstructor stays
bitwise unchanged."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from synthesis_in_style_tpu.losses.perceptual import PerceptualAndStyleLoss as JaxPerceptual
from synthesis_in_style_tpu.models import autoencoder as jae
from synthesis_in_style_tpu.models.stylegan2 import Discriminator as JaxDiscriminator
from synthesis_in_style_tpu.updaters import adversarial_updater as jadv
from synthesis_in_style_tpu_torch.cli import train_adversarial_generator as cli
from synthesis_in_style_tpu_torch.losses.perceptual import PerceptualAndStyleLoss
from synthesis_in_style_tpu_torch.models import autoencoder as tae
from synthesis_in_style_tpu_torch.models import factory
from synthesis_in_style_tpu_torch.models.stylegan2 import Discriminator
from synthesis_in_style_tpu_torch.updaters import adversarial_updater as tadv
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    autoencoder_params_from_jax,
    discriminator_params_from_jax,
    save_autoencoder_snapshot,
    vgg16_features_params_from_jax,
)
from synthesis_in_style_tpu_torch.utils.png import write_png

from tests.torch_autoencoder_fixtures import (
    SGD,
    SIZE,
    assert_close,
    assert_updates,
    images,
    init_jax,
    jax_decoder,
    load_port,
    numpy_tree,
    port_decoder,
    remove_files,
    snapshot,
    stylegan_autoencoders,
    wplus_pair,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_create_mask_matches_jax():
    binary = np.where(images(seed=3) > 0, 1.0, -1.0).astype(np.float32)
    got = tadv.create_mask(torch.from_numpy(binary))
    assert_close(got, jadv.create_mask(jnp.asarray(binary)), "mask")
    assert got.shape == (2, SIZE, SIZE, 1) and not got.requires_grad


def _float_keys(sd, prefix=""):
    return [k for k, v in sd.items() if k.startswith(prefix) and v.is_floating_point()]


def test_adversarial_steps_match_jax():
    lr = 1e-3
    jenc6, tenc6 = wplus_pair(in_ch=6)
    jgen = jae.ContentAndStyleStyleganAutoencoder(encoder=jenc6, decoder=jax_decoder())
    z = jnp.zeros((1, SIZE, SIZE, 3))
    g_vars = init_jax(jgen, z, z, seed=4)
    jrec, r_vars, trec = stylegan_autoencoders(seed=5)
    jdisc = JaxDiscriminator(size=SIZE, channel_multiplier=1)
    d_params = numpy_tree(jax.jit(jdisc.init)(jax.random.PRNGKey(6), z)["params"])
    jperc = JaxPerceptual(use_style_loss=False)
    state = jadv.AdversarialTrainState(
        g_params=g_vars["params"], g_batch_stats=g_vars["batch_stats"],
        g_noises=g_vars["noises"], d_params=d_params, reconstructor_variables=r_vars,
        g_opt=optax.sgd(lr).init(g_vars["params"]), d_opt=optax.sgd(lr).init(d_params),
        step=jnp.zeros((), jnp.int32))
    steps = jadv.make_adversarial_steps(jgen, jdisc, jrec, optax.sgd(lr), optax.sgd(lr), jperc,
                                        donate=False)

    tgen = load_port(tae.ContentAndStyleStyleganAutoencoder(tenc6, port_decoder()), g_vars)
    disc = Discriminator(SIZE, channel_multiplier=1)
    disc.load_state_dict(discriminator_params_from_jax(d_params), strict=True)
    tperc = PerceptualAndStyleLoss(
        state=vgg16_features_params_from_jax(numpy_tree(jperc.variables["params"])),
        use_style_loss=False)
    tstate = tadv.AdversarialTrainState(tgen.train(), disc, trec.requires_grad_(False),
                                        SGD(tgen.parameters(), lr), SGD(disc.parameters(), lr))
    tsteps = tadv.make_adversarial_steps(tperc)
    g_before, d_before, r_before = snapshot(tgen), snapshot(disc), snapshot(trec)

    binary = np.where(images(seed=7) > 0.3, 1.0, -1.0).astype(np.float32)
    style = images(seed=8)
    jb, js = jnp.asarray(binary), jnp.asarray(style)
    tb, ts = torch.from_numpy(binary), torch.from_numpy(style)
    key = jax.random.PRNGKey(0)
    state, jd = steps["d_step"](state, jb, js, key)
    td = tsteps["d_step"](tstate, tb, ts)
    for k in ("loss", "real_score", "fake_score"):
        assert_close(td[k], jd[k], f"d {k}")
    state, jr = steps["d_reg_step"](state, js)
    tr = tsteps["d_reg_step"](tstate, ts)
    assert_close(tr["gradient_penalty"], jr["gradient_penalty"], "r1", rel=1e-3)
    state, jg = steps["g_step"](state, jb, js, key)
    tg = tsteps["g_step"](tstate, tb, ts)
    for k in ("loss", "discriminator_loss", "reconstruction_loss", "perceptual_loss",
              "style_loss"):
        assert_close(tg[k], jg[k], f"g {k}")
    assert tstate.step == 1
    want_d = discriminator_params_from_jax(numpy_tree(state.d_params))
    scale = max(float(v.abs().max()) for v in want_d.values())
    for k, v in want_d.items():
        assert_close(disc.state_dict()[k], v.numpy(), f"D {k}", scale=scale)
    # D moved by its D step and its R1 step
    assert_updates(disc.state_dict(), d_before, want_d, want_d, "D")
    want_g = autoencoder_params_from_jax({"params": numpy_tree(state.g_params),
                                          "batch_stats": numpy_tree(state.g_batch_stats),
                                          "noises": g_vars["noises"]})
    keys = _float_keys(want_g)
    scale = max(float(want_g[k].abs().max()) for k in keys)
    got = tgen.state_dict()
    for k in keys:
        assert_close(got[k], want_g[k].numpy(), f"G {k}", scale=scale)
    # G's optimizer covers the whole generation autoencoder: the encoder and
    # the decoder moved, each held to its own largest update; the encoder's
    # BatchNorm statistics advanced in the D step and in the G step
    params = {n for n, _ in tgen.named_parameters()}
    groups = {"encoder": [k for k in keys if k in params and k.startswith("encoder.")],
              "decoder": [k for k in keys if k in params and k.startswith("decoder.")],
              "statistics": [k for k in keys if k not in params and k.startswith("encoder.")]}
    for name, group in groups.items():
        assert_updates(got, g_before, want_g, group, f"G {name}")
    assert all(torch.equal(got[k], g_before[k]) for k in keys if k.startswith("decoder.noises"))
    got_r = trec.state_dict()
    assert all(torch.equal(got_r[k], v) for k, v in r_before.items())


def test_r1_fires_every_16_iterations():
    fired = []
    stub = {"d_step": lambda s, b, st, g: {}, "g_step": lambda s, b, st, g: {},
            "d_reg_step": lambda s, st: fired.append(updater.iteration) or {}}
    batches = {"binary_images": iter([torch.zeros(1)] * 17),
               "original_images": iter([torch.zeros(1)] * 17)}
    updater = tadv.AdversarialAutoencoderUpdater(stub, None, batches, device="cpu")
    for _ in range(17):
        updater.update()
    assert fired == [0, 16]
    assert tadv.DEFAULT_LOSS_WEIGHTS == jadv.DEFAULT_LOSS_WEIGHTS


def _write_images(directory, n, size, binary, seed):
    directory.mkdir(parents=True)
    rs = np.random.RandomState(seed)
    names = []
    for i in range(n):
        img = rs.randint(0, 256, (size, size, 3)).astype(np.uint8)
        if binary:
            img = np.where(img.mean(-1, keepdims=True) > 127, 255, 0).repeat(3, -1).astype(np.uint8)
        write_png(directory / f"{i}.png", img)
        names.append(f"{i}.png")
    (directory / "images.json").write_text(json.dumps(names))
    return directory / "images.json"


@pytest.mark.parametrize("variant", [2, 1])
def test_cli_end_to_end(tmp_path, variant):
    size = 16
    config = {"image_size": size, "latent_size": 32, "n_mlp": 2, "channel_multiplier": 1,
              "stylegan_variant": variant, "batch_size": 2, "max_iter": 2, "lr": 1e-4,
              "snapshot_save_iter": 2, "image_save_iter": 2, "log_iter": 1}
    run = tmp_path / "ae_run"
    (run / "config").mkdir(parents=True)
    (run / "config" / "config.json").write_text(json.dumps(config))
    ckpt = run / "checkpoints" / "ae.pt"
    if variant == 2:
        ae = factory.get_autoencoder(config)
        ae.encoder.init_weights(torch.Generator().manual_seed(0))
        ae.decoder.init_weights(torch.Generator().manual_seed(1))
        save_autoencoder_snapshot(ckpt, ae)
    else:  # a checkpoint without an autoencoder: every network starts fresh
        ckpt.parent.mkdir(parents=True)
        torch.save({"g_ema": {}}, ckpt)
    real = _write_images(tmp_path / "real", 4, size, False, 1)
    binary = _write_images(tmp_path / "binary", 4, size, True, 2)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    args = cli.build_parser().parse_args(
        [str(cfg_path), str(ckpt), "-o", str(real), "-f", str(binary), "-d", "cpu", "--debug"])
    assert cli.build_parser().parse_args([str(cfg_path), str(ckpt), "-o", "a", "-f", "b"]) \
        .device == "cuda"
    args.log_dir = str(tmp_path / "logs")
    trainer = cli.main(args)
    assert trainer.updater.iteration == 2
    snap = torch.load(tmp_path / "logs" / "checkpoints" / "iter_00000002.pt",
                      weights_only=True)
    assert {"generator", "discriminator", "generator_optimizer",
            "discriminator_optimizer"} <= set(snap)
    with Image.open(tmp_path / "logs" / "images" / "iter_00000002.png") as png:
        assert png.size == (4 * size, 2 * size)
    log = [json.loads(line) for line in (tmp_path / "logs" / "log.jsonl").read_text()
           .splitlines()]
    assert len(log) >= 2
    assert all(np.isfinite(v) for rec in log for k, v in rec.items()
               if k.startswith(("generator/", "discriminator/")))
    assert "discriminator/gradient_penalty" in log[0]
    if variant == 2:  # the generation decoder started from the snapshot's g_ema (its
        # noise buffers are not trained)
        buffers = {k: v for k, v in snap["generator"].items() if k.startswith("decoder.noises")}
        assert buffers and all(torch.equal(v, ae.decoder.state_dict()[k[len("decoder."):]])
                               for k, v in buffers.items())
    remove_files(ckpt, tmp_path / "logs" / "checkpoints" / "iter_00000002.pt")
