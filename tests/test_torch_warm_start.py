"""The port's shape-tolerant GAN warm start (`--init-ckpt`) against the JAX
package's on the CPU: a JAX snapshot tree of a small GAN is re-keyed with
`upscale_gan_snapshot_tree` and merged into a larger fresh state with
`merge_matching_leaves`; the result, carried across with the port's
converters, equals tensor for tensor (exactly: the merge only moves
tensors) what the port's own functions make of the converted small snapshot
and the converted fresh state. The copied / fresh counts agree (the port's
generator counts its noise buffers, JAX keeps them in `g_noises`). Also the
same-size passthrough, a rejected downscale, a non-tensor entry kept fresh,
and the training CLI's `--init-ckpt`."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models.stylegan2 import Discriminator as JaxDiscriminator
from synthesis_in_style_tpu.models.stylegan2 import Generator as JaxGenerator
from synthesis_in_style_tpu.utils.checkpoint import (
    merge_matching_leaves as jax_merge,
    upscale_gan_snapshot_tree as jax_upscale,
)
from synthesis_in_style_tpu_torch.cli import train_stylegan_2 as cli
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    discriminator_params_from_jax,
    generator_params_from_jax,
    load_gan_snapshot,
    merge_matching_leaves,
    upscale_gan_snapshot_tree,
)
from synthesis_in_style_tpu_torch.utils.png import write_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

STYLE_DIM, N_MLP = 32, 2


@functools.lru_cache(maxsize=None)
def _jax_inits(size: int):
    """The jitted init functions at `size` (compiled once for every seed)."""
    return (jax.jit(JaxGenerator(size=size, style_dim=STYLE_DIM, n_mlp=N_MLP).init),
            jax.jit(JaxDiscriminator(size=size).init))


@functools.lru_cache(maxsize=None)
def _jax_state(size: int, seed: int):
    """JAX generator variables, an EMA copy that differs from them, and
    discriminator params at `size`, as numpy trees."""
    g_init, d_init = _jax_inits(size)
    g_vars = g_init({"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(seed + 1)},
                    [jnp.zeros((1, STYLE_DIM))])
    d_params = d_init(jax.random.PRNGKey(seed + 2), jnp.zeros((1, size, size, 3)))["params"]
    g_vars = jax.tree_util.tree_map(np.asarray, g_vars)
    rs = np.random.RandomState(seed)
    g_ema = jax.tree_util.tree_map(
        lambda x: (x + 0.01 * rs.randn(*x.shape)).astype(np.float32), g_vars["params"])
    return {"generator": g_vars["params"], "g_ema": g_ema, "g_noises": g_vars["noises"],
            "discriminator": jax.tree_util.tree_map(np.asarray, d_params)}


def _to_port(tree):
    """A JAX snapshot tree -> the port's {generator, g_ema, discriminator}
    state dicts (the noise buffers in both generator state dicts)."""
    return {"generator": generator_params_from_jax({"params": tree["generator"],
                                                    "noises": tree["g_noises"]}),
            "g_ema": generator_params_from_jax({"params": tree["g_ema"],
                                                "noises": tree["g_noises"]}),
            "discriminator": discriminator_params_from_jax(tree["discriminator"])}


def _jax_warm_start(src, fresh, source_size, target_size):
    tree = jax_upscale(src, source_size, target_size)
    merged, counts = {}, {}
    for key in ("generator", "discriminator", "g_ema", "g_noises"):
        merged[key], copied, kept = jax_merge(fresh[key], tree[key])
        counts[key] = (copied, kept)
    merged = jax.tree_util.tree_map(np.asarray, merged)
    return merged, counts


def _port_warm_start(src, fresh, source_size, target_size):
    tree = upscale_gan_snapshot_tree(src, source_size, target_size)
    merged, counts = {}, {}
    for key in ("generator", "discriminator", "g_ema"):
        merged[key], copied, kept = merge_matching_leaves(fresh[key], tree[key])
        counts[key] = (copied, kept)
    return merged, counts


@pytest.mark.parametrize("source_size,target_size", [(16, 32), (32, 64), (32, 32)])
def test_warm_start_matches_jax(source_size, target_size):
    src = _jax_state(source_size, 0)
    fresh = _jax_state(target_size, 10)
    jax_merged, jax_counts = _jax_warm_start(src, fresh, source_size, target_size)
    ours, counts = _port_warm_start(_to_port(src), _to_port(fresh), source_size, target_size)

    expected = _to_port(jax_merged)
    for key in ("generator", "discriminator", "g_ema"):
        assert set(ours[key]) == set(expected[key]), key
        for name, value in expected[key].items():
            assert torch.equal(ours[key][name], value), (key, name)
    noise_copied, noise_fresh = jax_counts["g_noises"]
    for key in ("generator", "g_ema"):
        assert counts[key] == (jax_counts[key][0] + noise_copied,
                               jax_counts[key][1] + noise_fresh), key
    assert counts["discriminator"] == jax_counts["discriminator"]
    if source_size == target_size:
        for key in ("generator", "discriminator", "g_ema"):
            assert counts[key][1] == 0, key
    else:
        # the larger model's extra stages (and the discriminator's input
        # layer) keep their init; the 4px end is copied
        assert counts["generator"][1] > 0 and counts["discriminator"][1] > 0
        port_src = _to_port(src)
        for name in ("input.input", "conv1.conv.weight", "convs.0.conv.weight"):
            assert torch.equal(ours["generator"][name], port_src["generator"][name])
        assert torch.equal(ours["discriminator"]["final_linear.1.weight"],
                           port_src["discriminator"]["final_linear.1.weight"])


def test_discriminator_blocks_shift_by_the_size_ratio():
    src = {"discriminator": {"convs.0.0.weight": torch.ones(1), "convs.1.conv1.0.weight":
                             torch.full((2,), 1.0), "convs.3.skip.1.weight": torch.zeros(3),
                             "final_conv.0.weight": torch.ones(4)},
           "generator": {"convs.0.conv.weight": torch.ones(5)}}
    out = upscale_gan_snapshot_tree(src, 32, 128)
    assert set(out["discriminator"]) == {"convs.3.conv1.0.weight", "convs.5.skip.1.weight",
                                         "final_conv.0.weight"}
    assert out["generator"] is src["generator"]
    assert upscale_gan_snapshot_tree(src, 64, 64)["discriminator"] is src["discriminator"]


def test_downscale_is_rejected():
    with pytest.raises(ValueError, match="larger"):
        upscale_gan_snapshot_tree({"discriminator": {}}, 64, 32)


def test_mismatched_entries_keep_their_fresh_init():
    """A dict where a tensor stands (the JAX merge crashes there), another
    shape, another dtype and a missing key all keep the fresh tensor."""
    fresh = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(2),
             "d": torch.zeros(1), "e": torch.zeros(3)}
    loaded = {"a": {"nested": torch.ones(2, 3)}, "b": torch.ones(5),
              "c": torch.ones(2, dtype=torch.float64), "e": torch.ones(3), "extra": torch.ones(1)}
    merged, copied, kept = merge_matching_leaves(fresh, loaded)
    assert (copied, kept) == (1, 4)
    assert set(merged) == set(fresh)
    for key in "abcd":
        assert merged[key] is fresh[key]
    assert torch.equal(merged["e"], torch.ones(3)) and merged["e"] is not loaded["e"]


def _cli_inputs(tmp_path, size, max_iter):
    rs = np.random.RandomState(0)
    data = tmp_path / f"data{size}"
    data.mkdir()
    names = []
    for i in range(4):
        write_png(data / f"p{i}.png", rs.randint(0, 256, (size, size, 3)).astype(np.uint8))
        names.append(f"p{i}.png")
    (data / "train.json").write_text(json.dumps(names))
    config = {"image_save_iter": 100, "snapshot_save_iter": max_iter, "log_iter": 1,
              "max_iter": max_iter, "batch_size": 2, "lr": 0.001,
              "regularization": {"g_interval": 4, "d_interval": 16, "r1_weight": 10,
                                 "path_reg_weight": 2},
              "latent_size": STYLE_DIM, "n_mlp": N_MLP, "channel_multiplier": 2,
              "style_mixing_prob": 0.9, "stylegan_variant": 2, "image_size": size}
    (data / "config.json").write_text(json.dumps(config))
    return data


def _run(data, log_dir, *extra):
    argv = [str(data / "config.json"), "--images", str(data / "train.json"), "-l", str(log_dir),
            "-d", "cpu", "--debug", *extra]
    return cli.main(cli.resolve_log_dir(cli.build_parser().parse_args(argv)))


def test_cli_init_ckpt_warm_starts_a_larger_run(tmp_path, capsys):
    """--init-ckpt of a 16px snapshot into a 32px run: every network says
    what it copied; before training the copied tensors are the snapshot's
    (g_ema from g_ema, not from the generator), and the optimizers start
    fresh (their step counts are the new run's own)."""
    small = _run(_cli_inputs(tmp_path, 16, 1), tmp_path / "small")
    (run,) = (tmp_path / "small" / "stylegan2").iterdir()
    snap_path = run / "checkpoints" / "iter_00000001.pt"
    snap = load_gan_snapshot(snap_path)
    assert small.updater.iteration == 1

    captured = {}
    original = cli.warm_start

    def recorded(state, init_ckpt, image_size):
        counts = original(state, init_ckpt, image_size)
        captured["counts"] = counts
        captured["g_ema"] = {k: v.clone() for k, v in state.g_ema.state_dict().items()}
        captured["disc"] = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
        captured["g_steps"] = state.g_optimizer.count
        return counts

    cli.warm_start = recorded
    try:
        big = _run(_cli_inputs(tmp_path, 32, 1), tmp_path / "big", "--init-ckpt", str(snap_path))
    finally:
        cli.warm_start = original
    out = capsys.readouterr().out
    for key in ("generator", "discriminator", "g_ema"):
        copied, fresh = captured["counts"][key]
        assert f"warm start {key} from 16px: {copied} copied, {fresh} kept fresh" in out
        assert copied > 0 and fresh > 0
    assert captured["g_steps"] == 0
    assert torch.equal(captured["g_ema"]["conv1.conv.weight"], snap["g_ema"]["conv1.conv.weight"])
    assert not torch.equal(snap["g_ema"]["conv1.conv.weight"],
                           snap["generator"]["conv1.conv.weight"])
    # the 16px discriminator's first block is the 32px one's second
    assert torch.equal(captured["disc"]["convs.2.conv1.0.weight"],
                       snap["discriminator"]["convs.1.conv1.0.weight"])
    assert big.updater.iteration == 1
    assert big.updater.state.g_optimizer.count == 2  # the G step and path length at 0
