"""The port's TransUNet (models/trans_u_net.py) against the JAX package's on
the CPU, from the same weights (`transunet_params_from_jax`) and inputs
(numpy seeds), with every dropout rate at 0 (flax's and torch's draws
differ).

* `resize_bilinear_align_corners` and the config registry;
* the `testing` ViT (64px) and a shrunk hybrid (R50 (1, 1, 1), hidden 32,
  4 heads, 2 layers, grid 16x16 at 256px: 256 tokens): eval logits within
  1e-4 of max|ref|, and train-mode BatchNorm running statistics after one
  forward within 1e-5 (flax's momentum 0.99 and biased variance);
* `attention_impl="flash"` (the port's plain version on the CPU) against the
  JAX package's `impl="flash"` run in Pallas interpret mode, the JAX test's
  own route (in a child process that dispatches synchronously:
  tests/pallas_interpret.py says why): outputs within 2e-5, and gradients
  within 2e-4 of each leaf's scale floored at 1 % of the global scale (the
  JAX test's rule: the key bias's gradient is zero up to rounding on both
  sides);
* the flash guards (attention dropout, a token count not a multiple of 128);
* one TransUNet step (0.5 * CE + 0.5 * Dice, SGD with momentum and weight
  decay at the schedule's first rate) against `make_transunet_train_step`:
  in float32 the losses within 1e-5 and parameters within 1e-4 of
  max|ref|; in bfloat16 (every floating parameter cast on both sides) the
  losses within 1e-3, and the share of elements whose SGD update differs by
  more than 5 % of its tensor's largest reference update no larger than the
  share by which the JAX bfloat16 step differs from the JAX float32 step
  (bfloat16 keeps 8 bits: convolutions, GroupNorm and LayerNorm round at
  other places in the two frameworks);
* the reference `.pt` layout: the port's state dict through the JAX
  package's `torch_transunet_to_flax` gives back the JAX variables;
* `load_npz_weights` against the JAX function on an npz written from JAX
  parameters whose position-embedding grid (8x8) is resized to 16x16;
* the builder's optimizer (torch SGD against optax's chain) over three
  steps, its snapshot round trip, and the builder's `pretrained_path`.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from synthesis_in_style_tpu.models import trans_u_net as jax_tu
from synthesis_in_style_tpu.models.ema_net import resize_bilinear_align_corners as jax_resize
from synthesis_in_style_tpu.training_builder.base import BaseTrainBuilder as JaxBuilder
from synthesis_in_style_tpu.updaters.segmentation_updater import (
    SegTrainState,
    make_transunet_train_step,
)
from synthesis_in_style_tpu.utils.checkpoint import torch_transunet_to_flax
from synthesis_in_style_tpu_torch.core import schedules
from synthesis_in_style_tpu_torch.models import trans_u_net as tu
from synthesis_in_style_tpu_torch.ops.resize import resize_bilinear_align_corners
from synthesis_in_style_tpu_torch.updaters.segmentation_updater import (
    SGDOptimizer,
    transunet_train_step,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import transunet_params_from_jax
from pallas_interpret import run_in_sync_child
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

NUM_CLASSES = 3
CONFIG = {"lr": 0.01, "momentum": 0.9, "weight_decay": 0.0001, "end_lr": 1e-8,
          "cosine_max_update_epoch": 2}
PER_EPOCH = 5


def vit_testing_config(impl="xla"):
    config = jax_tu.get_testing_config()
    config["transformer"]["dropout_rate"] = 0.0
    config["attention_impl"] = impl
    return config


def hybrid_config():
    config = jax_tu.get_r50_b16_config()
    config["resnet"] = {"num_layers": (1, 1, 1), "width_factor": 1}
    config["hidden_size"] = 32
    config["transformer"].update({"mlp_dim": 64, "num_heads": 4, "num_layers": 2,
                                  "dropout_rate": 0.0})
    config["decoder_channels"] = (16, 8, 4, 2)
    return config


def _randomize(variables, seed=1):
    """Non-trivial BatchNorm statistics and norm scales, so that eval mode
    and the conversions are exercised."""
    rs = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(np.array, variables)

    def walk(tree, key):
        for name, value in tree.items():
            if isinstance(value, dict):
                walk(value, name)
            elif name == "mean":
                tree[name] = rs.normal(0, 0.1, value.shape).astype(np.float32)
            elif name == "var":
                tree[name] = rs.uniform(0.5, 1.5, value.shape).astype(np.float32)
            elif name == "scale":
                tree[name] = rs.uniform(0.8, 1.2, value.shape).astype(np.float32)
            elif name == "position_embeddings":
                tree[name] = rs.normal(0, 0.02, value.shape).astype(np.float32)

    walk(variables, "")
    return variables


def jax_model(config, size):
    model = jax_tu.VisionTransformer(config=config, img_size=size, num_classes=NUM_CLASSES)
    variables = _jit_init(model, jnp.zeros((1, size, size, 3)))
    return model, _randomize(dict(variables))


def _jit_init(model, x):
    """model.init under jit: one compile instead of op-by-op dispatch."""
    return jax.jit(lambda key, x: model.init({"params": key}, x, train=False))(
        jax.random.PRNGKey(0), x)


def port_model(config, size, variables):
    net = tu.VisionTransformer(config, size, NUM_CLASSES)
    net.load_state_dict(transunet_params_from_jax(variables), strict=True)
    return net


def _images(size, batch=2, seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def testing_vit():
    return (vit_testing_config(), 64, *jax_model(vit_testing_config(), 64))


@pytest.fixture(scope="module")
def hybrid():
    return (hybrid_config(), 256, *jax_model(hybrid_config(), 256))


@pytest.mark.parametrize("shape, out", [((2, 5, 7, 3), (10, 14)), ((1, 1, 4, 2), (2, 8)),
                                        ((1, 6, 6, 1), (6, 6))])
def test_resize_bilinear_align_corners_matches_jax(shape, out):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), *out))
    # the port's shared op (ops/resize.py) takes the port's NCHW layout
    got = resize_bilinear_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), *out)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_config_registry_matches_jax():
    assert set(tu.VIT_CONFIGS) == set(jax_tu.VIT_CONFIGS)
    for name, make in tu.VIT_CONFIGS.items():
        assert make() == jax_tu.VIT_CONFIGS[name](), name


@pytest.mark.parametrize("which", ["testing_vit", "hybrid"])
def test_eval_logits_and_train_statistics_match_jax(which, request):
    config, size, model, variables = request.getfixturevalue(which)
    x = _images(size)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    net = port_model(config, size, variables).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, size, size, NUM_CLASSES)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()

    _, new_state = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    want = transunet_params_from_jax({"params": variables["params"],
                                      "batch_stats": new_state["batch_stats"]})
    net.train()
    with torch.no_grad():
        net(torch.from_numpy(x).permute(0, 3, 1, 2))
    state = net.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * (1 + 2 * len(config["decoder_channels"]))
    for name in stats:
        np.testing.assert_allclose(state[name].numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_one_channel_input_is_repeated(testing_vit):
    config, size, _, variables = testing_vit
    net = port_model(config, size, variables).eval()
    x = torch.from_numpy(_images(size)[..., :1]).permute(0, 3, 1, 2)
    with torch.no_grad():
        torch.testing.assert_close(net(x), net(x.repeat(1, 3, 1, 1)))


def _jax_flash_path(x):
    """The JAX package's own flash test's route at x's size (testing config,
    2 classes, its init), run by `run_in_sync_child` in interpret mode: the
    eval output and the gradients of sum(y^2) in train mode, with the
    variables, flattened."""
    size, classes = x.shape[1], 2
    model = jax_tu.VisionTransformer(config=vit_testing_config("flash"), img_size=size,
                                     num_classes=classes)
    variables = _jit_init(jax_tu.VisionTransformer(config=vit_testing_config(), img_size=size,
                                                   num_classes=classes), jnp.asarray(x))
    ref = model.apply(variables, jnp.asarray(x), train=False)

    def loss(params):
        y = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        jnp.asarray(x), train=True, mutable=["batch_stats"])[0]
        return jnp.sum(y ** 2)

    # un-jitted, as the JAX package's test runs it (under jit XLA fuses and
    # rounds elsewhere: 3e-4 of the position embeddings' scale)
    grads = jax.grad(loss)(variables["params"])
    flat = {f"variables/{k}": v for k, v in flatten_dict(dict(variables), sep="/").items()}
    flat.update({f"grads/{k}": v for k, v in flatten_dict(dict(grads), sep="/").items()})
    return {"ref": ref, **flat}


def _unflatten(flat, prefix):
    return unflatten_dict({k[len(prefix) + 1:]: v for k, v in flat.items()
                           if k.startswith(prefix + "/")}, sep="/")


def test_flash_matches_the_jax_flash_path_in_interpret_mode(tmp_path):
    """The JAX package's own flash test (testing config at 256px: 256
    tokens, 2 classes, its init and input), against the port."""
    size, classes = 256, 2
    x = np.random.default_rng(0).normal(size=(1, size, size, 3)).astype(np.float32)
    out = run_in_sync_child(_jax_flash_path, tmp_path, x=x)
    ref = out["ref"]
    numpy_vars = _unflatten(out, "variables")
    ref_grads = transunet_params_from_jax({"params": _unflatten(out, "grads"),
                                           "batch_stats": numpy_vars["batch_stats"]})

    net = tu.VisionTransformer(vit_testing_config("flash"), size, classes)
    net.load_state_dict(transunet_params_from_jax(numpy_vars), strict=True)
    assert all(block.attn.impl == "flash" for block in net.transformer.encoder.layer)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)

    net.train()
    y = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    names = [n for n, _ in net.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad((y ** 2).sum(), list(net.parameters()))))
    global_scale = max(float(ref_grads[n].abs().max()) for n in names)
    for name in names:
        want = ref_grads[name]
        scale = max(float(want.abs().max()), 1e-2 * global_scale)
        err = float((grads[name] - want).abs().max()) / scale
        assert err <= 2e-4, (name, err)


def test_flash_guards():
    attn = tu.Attention(16, 2, dropout_rate=0.1, impl="flash")
    with pytest.raises(ValueError, match="attention_dropout_rate"):
        attn(torch.zeros(1, 128, 16))
    attn = tu.Attention(16, 2, impl="flash")
    with pytest.raises(ValueError, match="multiple of 128"):
        attn(torch.zeros(1, 64, 16))
    assert attn(torch.zeros(1, 128, 16)).shape == (1, 128, 16)
    with pytest.raises(ValueError, match="'xla' or 'flash'"):
        tu.Attention(16, 2, impl="pallas")


def _jax_schedule():
    return JaxBuilder.lr_schedule(SimpleNamespace(
        config=CONFIG, train_data_loader=[None] * PER_EPOCH, _base_lr=lambda: CONFIG["lr"]))


def _jax_tx():
    return optax.chain(optax.add_decayed_weights(CONFIG["weight_decay"]),
                       optax.sgd(_jax_schedule(), momentum=CONFIG["momentum"]))


def _port_optimizer(net):
    return SGDOptimizer(net.parameters(), schedules.segmentation_lr_schedule(CONFIG, PER_EPOCH),
                        momentum=CONFIG["momentum"], weight_decay=CONFIG["weight_decay"])


def _both_steps(hybrid, compute_dtype=None):
    config, size, model, variables = hybrid
    rs = np.random.default_rng(4)
    images = rs.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    labels = rs.integers(0, NUM_CLASSES, (2, size, size)).astype(np.int32)
    tx = _jax_tx()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = SegTrainState(params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    step = make_transunet_train_step(model, tx, NUM_CLASSES, donate=False,
                                     compute_dtype=compute_dtype)
    state, jax_out = step(state, {"images": jnp.asarray(images),
                                  "segmented": jnp.asarray(labels)}, jax.random.PRNGKey(0))
    want = transunet_params_from_jax({
        "params": jax.tree_util.tree_map(np.asarray, state.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)})
    net = port_model(config, size, variables)
    before = copy.deepcopy(net.state_dict())
    batch = {"images": torch.from_numpy(images).permute(0, 3, 1, 2),
             "segmented": torch.from_numpy(labels).long()}
    out = transunet_train_step(net, _port_optimizer(net), batch, NUM_CLASSES,
                               getattr(torch, compute_dtype) if compute_dtype else None)
    return jax_out, out, want, net, before


@pytest.fixture(scope="module")
def float32_step(hybrid):
    return _both_steps(hybrid)


def test_one_transunet_step_matches_jax(float32_step):
    jax_out, out, want, net, _ = float32_step
    for key in ("combined", "CE", "Dice"):
        assert abs(float(out[key]) - float(jax_out[key])) <= 1e-5, key
    got = net.state_dict()
    params = {n for n, _ in net.named_parameters()}
    scale = max(float(want[n].abs().max()) for n in params)
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = 1e-4 * scale if name in params else 1e-5
        assert float((got[name] - value).abs().max()) <= tol, name


def _moved_differently(a: dict, b: dict, before: dict, names) -> float:
    """Share of elements whose update (after - before) in `a` differs from
    the one in `b` by more than 5 % of b's largest update in that tensor."""
    off = total = 0
    for name in names:
        ref_update = b[name] - before[name]
        diff = (a[name] - before[name] - ref_update).abs()
        off += int((diff > 0.05 * float(ref_update.abs().max())).sum())
        total += diff.numel()
    return off / total


def test_one_bfloat16_transunet_step_matches_jax(hybrid, float32_step):
    """The port's bfloat16 step is no further from the JAX package's
    bfloat16 step than that step is from the JAX float32 step (measured:
    25.4 % of the elements moved differently against 32.7 %, mostly in the
    backbone's weight-standardised convolutions)."""
    jax_out, out, want, net, before = _both_steps(hybrid, "bfloat16")
    for key in ("combined", "CE", "Dice"):
        assert abs(float(out[key]) - float(jax_out[key])) <= 1e-3 * abs(float(jax_out[key])), key
    names = [n for n, _ in net.named_parameters()]
    port_vs_jax = _moved_differently(net.state_dict(), want, before, names)
    jax_vs_float32 = _moved_differently(want, float32_step[2], before, names)
    assert port_vs_jax <= jax_vs_float32, (port_vs_jax, jax_vs_float32)
    got = net.state_dict()
    for name, value in want.items():  # BatchNorm running statistics stay float32
        if name.endswith(("running_mean", "running_var")):
            assert got[name].dtype == torch.float32
            assert float((got[name] - value).abs().max()) <= 1e-2, name


def test_optimizer_matches_optax_over_three_steps():
    rs = np.random.default_rng(5)
    p0 = rs.normal(size=(4, 3)).astype(np.float32)
    grads = [rs.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    tx = _jax_tx()
    params, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = SGDOptimizer([param], schedules.segmentation_lr_schedule(CONFIG, PER_EPOCH),
                       momentum=CONFIG["momentum"], weight_decay=CONFIG["weight_decay"])
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.from_numpy(g)])
        assert opt.count == i + 1
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(params), rtol=0,
                                   atol=1e-7)
    # the state dict carries the momentum and the count to a fresh optimizer
    other = torch.nn.Parameter(param.detach().clone())
    resumed = SGDOptimizer([other], schedules.segmentation_lr_schedule(CONFIG, PER_EPOCH),
                           momentum=CONFIG["momentum"], weight_decay=CONFIG["weight_decay"])
    resumed.load_state_dict(copy.deepcopy(opt.state_dict()))  # as from disk: no shared buffers
    assert resumed.count == 3
    g = rs.normal(size=(4, 3)).astype(np.float32)
    opt.step([torch.from_numpy(g)])
    resumed.step([torch.from_numpy(g)])
    torch.testing.assert_close(other, param, rtol=0, atol=0)


def test_reference_layout_round_trip(hybrid):
    config, size, _, variables = hybrid
    state = port_model(config, size, variables).state_dict()
    back = torch_transunet_to_flax({k: v.numpy() for k, v in state.items()})
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}))
    assert set(map(jax.tree_util.keystr, flat_back)) == set(map(jax.tree_util.keystr, flat_want))
    want = {jax.tree_util.keystr(k): v for k, v in flat_want.items()}
    for key, value in flat_back.items():
        np.testing.assert_array_equal(value, want[jax.tree_util.keystr(key)])
    for key in ("transformer.embeddings.hybrid_model.root.conv.weight",
                "transformer.embeddings.hybrid_model.body.block1.unit1.gn_proj.weight",
                "transformer.encoder.layer.1.attn.value.bias", "decoder.conv_more.1.running_var",
                "decoder.blocks.3.conv2.0.weight", "segmentation_head.0.bias"):
        assert key in state


def _npz_from_jax(params, hidden, grid_old):
    """An original-ViT npz (flax-era names) holding `params`' values, its
    position embeddings on a grid_old x grid_old grid with a class token."""
    rs = np.random.default_rng(6)
    w = {"embedding/kernel": params["patch_embeddings"]["kernel"],
         "embedding/bias": params["patch_embeddings"]["bias"],
         "Transformer/encoder_norm/scale": params["encoder_norm"]["scale"],
         "Transformer/encoder_norm/bias": params["encoder_norm"]["bias"],
         "Transformer/posembed_input/pos_embedding":
             rs.normal(size=(1, grid_old * grid_old + 1, hidden)).astype(np.float32)}
    i = 0
    while f"encoderblock_{i}" in params:
        block, root = params[f"encoderblock_{i}"], f"Transformer/encoderblock_{i}"
        heads = 4
        for name in ("query", "key", "value"):
            w[f"{root}/MultiHeadDotProductAttention_1/{name}/kernel"] = rs.normal(
                size=(hidden, heads, hidden // heads)).astype(np.float32)
            w[f"{root}/MultiHeadDotProductAttention_1/{name}/bias"] = rs.normal(
                size=(heads, hidden // heads)).astype(np.float32)
        w[f"{root}/MultiHeadDotProductAttention_1/out/kernel"] = rs.normal(
            size=(heads, hidden // heads, hidden)).astype(np.float32)
        w[f"{root}/MultiHeadDotProductAttention_1/out/bias"] = block["attn"]["out"]["bias"]
        for j, fc in ((0, "fc1"), (1, "fc2")):
            w[f"{root}/MlpBlock_3/Dense_{j}/kernel"] = block["ffn"][fc]["kernel"]
            w[f"{root}/MlpBlock_3/Dense_{j}/bias"] = block["ffn"][fc]["bias"]
        for j, norm in ((0, "attention_norm"), (2, "ffn_norm")):
            w[f"{root}/LayerNorm_{j}/scale"] = block[norm]["scale"] + 0.5
            w[f"{root}/LayerNorm_{j}/bias"] = block[norm]["bias"] + 0.1
        i += 1
    hybrid = params["hybrid_model"]
    w["conv_root/kernel"] = hybrid["root_conv"]["kernel"] * 2
    w["gn_root/scale"] = hybrid["root_gn"]["scale"] + 0.25
    w["gn_root/bias"] = hybrid["root_gn"]["bias"] + 0.5
    for name, unit in hybrid.items():
        if not name.startswith("block"):
            continue
        root = name.replace("_", "/")
        for j in (1, 2, 3):
            w[f"{root}/conv{j}/kernel"] = unit[f"conv{j}"]["kernel"] * 3
            w[f"{root}/gn{j}/scale"] = unit[f"gn{j}"]["scale"] + 0.5
            w[f"{root}/gn{j}/bias"] = unit[f"gn{j}"]["bias"] - 0.5
        if "downsample" in unit:
            w[f"{root}/conv_proj/kernel"] = unit["downsample"]["kernel"] * 4
            w[f"{root}/gn_proj/scale"] = unit["gn_proj"]["scale"] + 1.0
            w[f"{root}/gn_proj/bias"] = unit["gn_proj"]["bias"] + 1.0
    return {k: np.asarray(v, np.float32) for k, v in w.items()}


def test_load_npz_weights_matches_jax(hybrid, tmp_path, shrunk_registry):
    config, size, _, variables = hybrid
    weights = _npz_from_jax(variables["params"], config["hidden_size"], grid_old=8)
    want = transunet_params_from_jax({
        "params": jax_tu.load_npz_weights(variables["params"], weights, config),
        "batch_stats": variables["batch_stats"]})
    net = port_model(config, size, variables)
    got = tu.load_npz_weights(net.state_dict(), weights, config)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    assert not torch.equal(got["transformer.embeddings.position_embeddings"],
                           net.state_dict()["transformer.embeddings.position_embeddings"])

    # the builder applies `pretrained_path` when not fine-tuning
    from synthesis_in_style_tpu_torch.training_builder import TransUNetTrainBuilder

    path = tmp_path / "vit.npz"
    np.savez(path, **weights)
    builder = TransUNetTrainBuilder(_builder_config(pretrained_path=str(path)), device="cpu")
    loaded = builder.network.state_dict()
    for name in ("transformer.embeddings.position_embeddings",
                 "transformer.encoder.layer.0.attn.query.weight",
                 "transformer.embeddings.hybrid_model.root.conv.weight"):
        fresh = tu.load_npz_weights(
            TransUNetTrainBuilder(_builder_config(), device="cpu").network.state_dict(),
            weights, builder.network.config)[name]
        torch.testing.assert_close(loaded[name], fresh, rtol=0, atol=0)


@pytest.fixture()
def shrunk_registry(monkeypatch):
    """The shrunk hybrid registered as `hybrid-test` for the builder, which
    reads VIT_CONFIGS, for one test."""
    monkeypatch.setitem(tu.VIT_CONFIGS, "hybrid-test", hybrid_config)


def _builder_config(**extra):
    return {"network": "TransUNet", "pretrained_model_name": "hybrid-test", "num_classes": 3,
            "image_size": 256, "num_skip_channels": 3, "vit_patch_size": 16, **CONFIG, **extra}


def test_builder_builds_the_configured_network(shrunk_registry):
    from synthesis_in_style_tpu_torch.training_builder import (
        TransUNetTrainBuilder,
        get_train_builder_class,
    )

    config = _builder_config(attention_impl="flash")
    assert get_train_builder_class(config) is TransUNetTrainBuilder
    builder = TransUNetTrainBuilder(config, device="cpu")
    net = builder.network
    assert net.transformer.embeddings.position_embeddings.shape == (1, 256, 32)
    assert all(block.attn.impl == "flash" for block in net.transformer.encoder.layer)
    assert isinstance(builder.optimizer, SGDOptimizer)
    group = builder.optimizer.sgd.param_groups[0]
    assert (group["momentum"], group["weight_decay"], group["dampening"], group["nesterov"]) == \
        (0.9, 0.0001, 0, False)
    assert builder.segmenter_config().min_confidence == 0.0
    from synthesis_in_style_tpu_torch.training_builder import EMANetTrainBuilder

    assert get_train_builder_class({"network": "EMANet"}) is EMANetTrainBuilder
    from synthesis_in_style_tpu_torch.training_builder import PixelEnsembleTrainBuilder

    assert get_train_builder_class({"network": "PixelEnsemble"}) is PixelEnsembleTrainBuilder
    with pytest.raises(NotImplementedError, match="unknown network"):
        get_train_builder_class({"network": "UNet"})
