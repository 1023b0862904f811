"""The port's GAN training loop on the CPU: its optimizer and schedule
against optax on identical gradients (1e-6: the same float32 update
formula), a 4-iteration updater loop, and the training CLI end to end at a
tiny size (log, snapshot, sample grid, resume, and the snapshot's g_ema
loaded by the dataset path's `load_generator`)."""

import json
import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthesis_in_style_tpu.core.schedules import clamped_cosine as jax_clamped_cosine
from synthesis_in_style_tpu.data.json_dataset import normalize_to_tensor as jax_normalize
from synthesis_in_style_tpu_torch.cli import train_stylegan_2 as cli
from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.core.reporter import Reporter
from synthesis_in_style_tpu_torch.core.schedules import clamped_cosine
from synthesis_in_style_tpu_torch.data.json_dataset import normalize_to_tensor
from synthesis_in_style_tpu_torch.models.factory import load_generator
from synthesis_in_style_tpu_torch.models.stylegan2 import Discriminator, Generator
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import (
    GANOptimizer,
    StyleGAN2Config,
    StyleGAN2Updater,
    create_gan_train_state,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import load_gan_snapshot
from synthesis_in_style_tpu_torch.utils.png import write_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, STYLE_DIM = 16, 32


def test_clamped_cosine_matches_jax():
    ours, ref = clamped_cosine(8e-4, 10, 1e-8), jax_clamped_cosine(8e-4, 10, 1e-8)
    for step in (0, 1, 5, 9, 10, 11, 50):
        assert math.isclose(ours(step), float(ref(step)), rel_tol=1e-6), step


def test_optimizer_matches_optax_clip_adam_cosine():
    """Six updates with gradient norms below and above the clip; ratio 4/5
    betas as the CLI builds them; the schedule read at the update count."""
    rs = np.random.RandomState(0)
    shapes = [(3, 5), (7,), (2, 2, 3)]
    init = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(scale * rs.randn(*s)).astype(np.float32) for s in shapes]
             for scale in (0.01, 2.0, 0.1, 5.0, 0.05, 1.0)]
    ratio = 4 / 5
    sched_args = (1e-3 * ratio, 6, 1e-8)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(jax_clamped_cosine(*sched_args), b1=0.0**ratio, b2=0.99**ratio))
    params = [jnp.asarray(p) for p in init]
    opt_state = tx.init(params)
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = GANOptimizer(ours, clamped_cosine(*sched_args), (0.0**ratio, 0.99**ratio))
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.from_numpy(x) for x in g])
        for p, ref in zip(ours, params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert opt.count == len(grads)


def test_optimizer_gives_unreached_parameters_zero_gradients():
    """A None gradient still advances that parameter's Adam state, so every
    parameter shares one update count (as optax's)."""
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(3))
    opt = GANOptimizer([a, b], lambda step: 1e-3, (0.0, 0.99))
    opt.step([torch.ones(2), None])
    opt.step([torch.ones(2), torch.ones(3)])
    assert int(opt.adam.state[a]["step"]) == int(opt.adam.state[b]["step"]) == 2


def test_normalize_to_tensor_matches_jax():
    from PIL import Image

    rs = np.random.RandomState(1)
    for shape, size in (((24, 24, 3), 24), ((40, 30, 3), 16), ((10, 12, 3), 16)):
        image = rs.randint(0, 256, shape).astype(np.uint8)
        ref = jax_normalize(Image.fromarray(image), size, 3)
        got = normalize_to_tensor(image, size, 3).numpy()
        assert got.shape == ref.shape
        # exact without a resize; PIL and PyTorch bilinear agree within 1/255
        tol = 0.0 if shape[0] == size else 2.0 / 255 + 1e-6
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    gen = Generator(SIZE, STYLE_DIM, 2).init_weights(g)
    disc = Discriminator(SIZE).init_weights(g)
    sched = clamped_cosine(2e-3, 100, 1e-8)
    return create_gan_train_state(gen, disc, sched, sched, (0.0, 0.99), (0.0, 0.99))


def test_updater_runs_four_iterations():
    state = _tiny_state()
    g0 = [p.detach().clone() for p in state.generator.parameters()]
    d0 = [p.detach().clone() for p in state.discriminator.parameters()]
    e0 = [p.detach().clone() for p in state.g_ema.parameters()]
    batches = iter([torch.randn((4, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(i))
                    for i in range(4)])
    cfg = StyleGAN2Config(d_reg_every=2, g_reg_every=2, freeze_noise_layers=(0, 1))
    updater = StyleGAN2Updater(state, {"images": batches}, batch_size=4, cfg=cfg, device="cpu")
    reporter = Reporter()
    with reporter.scope():
        for _ in range(4):
            updater.update()
    means = reporter.flush()
    for key in ("train/discriminator_loss", "train/generator_loss", "train/r1_penalty",
                "train/path_loss", "train/mean_path_length"):
        assert math.isfinite(means[key]), key
    assert updater.iteration == 4 and state.step == 4
    assert state.g_optimizer.count == 6 and state.d_optimizer.count == 6  # 4 + 2 reg each
    assert float(state.mean_path_length) > 0
    for before, p in zip(g0, state.generator.parameters()):
        assert not torch.equal(before, p)
    for before, p in zip(d0, state.discriminator.parameters()):
        assert not torch.equal(before, p)
    # EMA moved toward the generator but not onto it
    state.generator.requires_grad_(False)
    dist0 = sum(float((e - p).abs().sum()) for e, p in zip(e0, state.generator.parameters()))
    dist1 = sum(float((e - p).abs().sum())
                for e, p in zip(state.g_ema.parameters(), state.generator.parameters()))
    assert 0 < dist1 < dist0
    # the noise buffers are not averaged
    for a, b in zip(state.g_ema.buffers(), state.generator.buffers()):
        assert torch.equal(a, b)


def _write_run_inputs(tmp_path, n_images=6):
    rs = np.random.RandomState(0)
    data = tmp_path / "data"
    data.mkdir()
    names = []
    for i in range(n_images):
        write_png(data / f"page_{i}.png", rs.randint(0, 256, (20, 20, 3)).astype(np.uint8))
        names.append(f"page_{i}.png")
    (data / "train.json").write_text(json.dumps(names))
    config = {"image_save_iter": 1, "snapshot_save_iter": 2, "log_iter": 1, "max_iter": 2,
              "batch_size": 2, "lr": 0.001,
              "regularization": {"g_interval": 4, "d_interval": 16, "r1_weight": 10,
                                 "path_reg_weight": 2},
              "latent_size": STYLE_DIM, "n_mlp": 2, "channel_multiplier": 2,
              "style_mixing_prob": 0.9, "stylegan_variant": 2, "compute_dtype": "bfloat16",
              "freeze_stochastic_noise_layers": [0, 1], "image_size": SIZE}
    (data / "config.json").write_text(json.dumps(config))
    return data


def _run_cli(data, log_dir, *extra):
    argv = [str(data / "config.json"), "--images", str(data / "train.json"), "-l", str(log_dir),
            "-d", "cpu", "--debug", *extra]
    return cli.main(cli.resolve_log_dir(cli.build_parser().parse_args(argv)))


def test_cli_trains_snapshots_and_feeds_the_dataset_path(tmp_path):
    data = _write_run_inputs(tmp_path)
    trainer = _run_cli(data, tmp_path / "logs")
    assert trainer.updater.iteration == 2
    (run,) = (tmp_path / "logs" / "stylegan2").iterdir()
    log = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    assert [e["iteration"] for e in log] == [1, 2]
    assert all(math.isfinite(e["train/discriminator_loss"]) for e in log)
    assert "train/r1_penalty" in log[0] and "train/path_loss" in log[0]
    assert sorted(p.name for p in (run / "images").iterdir()) == \
        ["iter_00000001.png", "iter_00000002.png"]

    snap_path = run / "checkpoints" / "iter_00000002.pt"
    snap = load_gan_snapshot(snap_path)
    assert snap["mean_path_length"] > 0
    assert snap["generator_optimizer"]["state"] and snap["discriminator_optimizer"]["state"]
    # the dataset path reads the config beside the snapshot and its g_ema
    config = load_config_from_checkpoint(snap_path)
    gen = load_generator(snap_path, config, device="cpu")
    for name, value in gen.state_dict().items():
        torch.testing.assert_close(value, snap["g_ema"][name], rtol=0, atol=0)
    with torch.no_grad():
        image, _ = gen([torch.randn(1, STYLE_DIM)], randomize_noise=False)
    assert image.shape == (1, SIZE, SIZE, 3) and torch.isfinite(image).all()

    # resume: weights, optimizer states and the path-length mean come back
    resumed = _run_cli(data, tmp_path / "resumed", "--resume-ckpt", str(snap_path))
    state = resumed.updater.state
    assert state.g_optimizer.count == snap["generator_optimizer"]["state"][0]["step"] + 3


@pytest.mark.parametrize("extra", [["--resume-ckpt", "latest"], ["--init-ckpt", "x.pt"],
                                   ["--val-images", "val.json"], ["-c", "cache"],
                                   ["--wandb-project-name", "p"], ["--profile-dir", "p"],
                                   ["-s", "swagan"], ["--local_rank", "1"]])
def test_cli_raises_on_what_is_not_ported(tmp_path, extra):
    data = _write_run_inputs(tmp_path, n_images=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run_cli(data, tmp_path / "logs", *extra)


def test_load_gan_snapshot_reads_a_reference_checkpoint(tmp_path):
    """A reference-layout .pt: the reference's blur buffers (`*.kernel`) are
    dropped, and a checkpoint without training_state has no path mean."""
    state = _tiny_state()
    d_sd = dict(state.discriminator.state_dict())
    d_sd["convs.1.conv2.0.kernel"] = torch.ones(4, 4)
    torch.save({"discriminator": d_sd, "g_ema": state.g_ema.state_dict()}, tmp_path / "ref.pt")
    snap = load_gan_snapshot(tmp_path / "ref.pt")
    assert set(snap) == {"discriminator", "g_ema", "mean_path_length"}
    assert snap["mean_path_length"] is None
    Discriminator(SIZE).load_state_dict(snap["discriminator"], strict=True)
    torch.save({"other": {}}, tmp_path / "bad.pt")
    with pytest.raises(KeyError):
        load_gan_snapshot(tmp_path / "bad.pt")


def test_optimizer_settings_follow_the_reg_ratio():
    settings = cli.optimizer_settings({"lr": 0.001, "max_iter": 10,
                                       "regularization": {"g_interval": 4, "d_interval": 16}})
    g_sched, g_betas = settings["generator"]
    d_sched, d_betas = settings["discriminator"]
    assert math.isclose(g_sched(0), 0.001 * 4 / 5) and math.isclose(d_sched(0), 0.001 * 16 / 17)
    assert g_betas == (0.0, 0.99 ** (4 / 5)) and d_betas == (0.0, 0.99 ** (16 / 17))
    assert math.isclose(g_sched(10), 1e-8)
    assert cli.frozen_noise_layers({"freeze_stochastic_noise_layers": True}, 3) == (0, 1, 2)
    assert cli.frozen_noise_layers({}, 3) == ()
