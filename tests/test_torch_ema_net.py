"""The port's EMANet against the JAX package's on the CPU: ResNet-50 at
48px, the EMA head narrowed to 64 channels and 8 bases (the JAX module's
`emau_channels` / `emau_k`), weights carried across with
`ema_net_params_from_jax`, inputs from numpy.

* Eval logits at output strides 8 and 16 within 1e-4 of max|ref|; the
  port's state dict read back by the JAX package's `torch_emanet_to_flax`
  has the JAX module's layout (its init traced, not run) and gives the same
  logits.
* One training step against `make_emanet_train_step` with the JAX builder's
  optimizer (SGD with momentum over three groups: conv weights with weight
  decay, BatchNorm scales, biases at twice the rate), dropout off on both
  sides (the dropout streams differ; the JAX module's dropout is
  intercepted, the port's rate set to 0).
  - In float64 (the JAX step under `jax.enable_x64`): every new parameter
    within 1e-6 of its own update (L2; measured <= 2.8e-8: both packages
    take the cross-entropy of float32 logits), the BatchNorm statistics
    within 1e-10 and µ within 1e-7 of max|ref| (the port averages the
    batch's µ in float32), the loss within 1e-6.
  - In float32: the loss, the BatchNorm running statistics and the new µ
    within 1e-4 (relative) of the JAX float32 step. The parameters' updates
    are ill-conditioned here (ReLU and BatchNorm at batch 2 over 6x6 maps
    amplify float32 rounding): the JAX package's own float32 updates sit
    3.2 % (L2) from its float64 step's, so the port's float32 updates must
    be no further from the JAX float64 step than the JAX float32 step's
    are, within a factor of 1.5, in L2 and in the worst tensor.
    `emau.conv1` receives no gradient, and both sides decay its weight as
    optax does.
* The same step in bfloat16: the port's updates, loss and µ no further from
  the JAX float64 step's than the JAX bfloat16 step's are, within a factor
  of 2 (bfloat16 rounding dominates a first SGD step's small gradients).
* The three SGD groups over 3 steps of given gradients against optax.
* ResNet-101 and -152: the port's state dict has the JAX module's layout.
* Page inference (`AnalysisSegmenter`) against the JAX package's, whose
  pages run on the module's seed-0 init µ (it drops the stored one): the
  port's buffer is set to that µ for the comparison.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as flax_nn

from synthesis_in_style_tpu.models import ema_net as jax_ema
from synthesis_in_style_tpu.models.base_segmenter import SegmenterConfig as JaxSegmenterConfig
from synthesis_in_style_tpu.segmentation import analysis_segmenter as jax_seg
from synthesis_in_style_tpu.training_builder.base import BaseTrainBuilder as JaxBuilder
from synthesis_in_style_tpu.training_builder.ema_net_builder import (
    EMANetTrainBuilder as JaxEMANetBuilder,
)
from synthesis_in_style_tpu.updaters.segmentation_updater import (
    SegTrainState,
    make_emanet_train_step,
)
from synthesis_in_style_tpu.utils.checkpoint import torch_emanet_to_flax
from synthesis_in_style_tpu_torch.core import schedules
from synthesis_in_style_tpu_torch.models.base_segmenter import SegmenterConfig
from synthesis_in_style_tpu_torch.models.ema_net import EMANet
from synthesis_in_style_tpu_torch.segmentation import analysis_segmenter as seg
from synthesis_in_style_tpu_torch.training_builder.ema_net_builder import emanet_param_groups
from synthesis_in_style_tpu_torch.updaters.segmentation_updater import (
    SGDOptimizer,
    emanet_train_step,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import ema_net_params_from_jax
from test_torch_page_inference import COLORS, _page
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, BATCH, NUM_CLASSES, EMAU_C, EMAU_K = 48, 2, 3, 64, 8
CONFIG = {"lr": 0.009, "lr_mom": 0.9, "em_mom": 0.9, "weight_decay": 0.0001,
          "end_lr": 1e-8, "cosine_max_update_epoch": 2}
PER_EPOCH = 5


def _jax_model(stride=8):
    return jax_ema.EMANet(num_classes=NUM_CLASSES, stride=stride, emau_channels=EMAU_C,
                          emau_k=EMAU_K)


@functools.lru_cache(maxsize=None)
def _variables():
    """Flax variables with nonzero biases, BN affine and statistics, and a
    µ: the port's seeded flax-style init read by the JAX package's
    `torch_emanet_to_flax` (no JAX init to compile; test_eval_logits_match_jax
    holds that layout against the JAX module's)."""
    net = EMANet(NUM_CLASSES, emau_channels=EMAU_C, emau_k=EMAU_K)
    net.init_weights(torch.Generator().manual_seed(8))
    flax = torch_emanet_to_flax({k: v.numpy() for k, v in net.state_dict().items()})
    variables = {"params": flax["params"], "batch_stats": flax["batch_stats"]}
    rs = np.random.RandomState(8)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf)
        if name.endswith("['bias']") or name.endswith("['mean']"):
            return (leaf + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        if name.endswith("['scale']") or name.endswith("['var']"):
            return (leaf * rs.uniform(0.5, 1.5, leaf.shape)).astype(np.float32)
        return leaf

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    mu = np.asarray(jax_ema.init_emau_mu(EMAU_C, EMAU_K, seed=3))
    return variables, mu


def _port(variables, mu, stride=8) -> EMANet:
    net = EMANet(NUM_CLASSES, stride=stride, emau_channels=EMAU_C, emau_k=EMAU_K)
    net.load_state_dict(ema_net_params_from_jax(variables, mu), strict=True)
    return net


def _images(seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max())
    return float(np.abs(got - ref).max()) / scale if scale else float(np.abs(got).max())


@pytest.mark.parametrize("stride", [8, 16])
def test_eval_logits_match_jax(stride):
    model = _jax_model(stride)
    variables, mu = _variables()
    apply = jax.jit(lambda v, x, m: model.apply(v, x, m, train=False))
    x = _images(1)
    ref = apply(variables, jnp.asarray(x), jnp.asarray(mu))
    net = _port(variables, mu, stride).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (BATCH, SIZE, SIZE, NUM_CLASSES)
    assert _rel(got.numpy(), ref) <= 1e-4
    # the port's state dict is the reference layout the JAX package reads,
    # with the JAX module's parameter and statistics shapes
    back = torch_emanet_to_flax({k: v.numpy() for k, v in net.state_dict().items()})
    shapes = jax.eval_shape(lambda k: model.init({"params": k, "dropout": k},
                                                 jnp.zeros((1, SIZE, SIZE, 3))),
                            jax.random.PRNGKey(0))
    for collection in ("params", "batch_stats"):
        assert jax.tree_util.tree_map(lambda a: a.shape, back[collection]) == \
            jax.tree_util.tree_map(lambda a: a.shape, shapes[collection]), collection
    again = apply({"params": back["params"], "batch_stats": back["batch_stats"]},
                  jnp.asarray(x), jnp.asarray(back["mu"]))
    assert _rel(again, ref) <= 1e-6


def _jax_schedule():
    return JaxBuilder.lr_schedule(SimpleNamespace(
        config=CONFIG, train_data_loader=[None] * PER_EPOCH, _base_lr=lambda: CONFIG["lr"]))


def _jax_tx():
    return JaxEMANetBuilder._build_optimizer(SimpleNamespace(
        config=CONFIG, lr_schedule=_jax_schedule))


def _port_optimizer(net):
    return SGDOptimizer(emanet_param_groups(net, CONFIG["weight_decay"]),
                        schedules.segmentation_lr_schedule(CONFIG, PER_EPOCH),
                        momentum=CONFIG["lr_mom"])


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _labels(seed=2):
    return np.random.RandomState(seed).randint(0, NUM_CLASSES, (BATCH, SIZE, SIZE))


@functools.lru_cache(maxsize=None)
def _jax_step_flax(dtype):
    """One JAX step, dropout off, from `_variables` as `dtype` ("float32",
    "bfloat16": the step's compute_dtype on float32 state, or "float64":
    state and images in float64 under `jax.enable_x64`): the new flax
    variables and µ as numpy, and the loss."""
    variables, mu = _variables()
    wide = jnp.float64 if dtype == "float64" else jnp.float32
    with jax.enable_x64(dtype == "float64"):
        def cast(leaf):
            return jnp.asarray(np.asarray(leaf, wide))

        tx = _jax_tx()
        params = jax.tree_util.tree_map(cast, variables["params"])
        state = SegTrainState(params=params,
                              batch_stats=jax.tree_util.tree_map(cast, variables["batch_stats"]),
                              opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                              extra=cast(mu))
        with flax_nn.intercept_methods(_no_dropout):
            step = make_emanet_train_step(_jax_model(), tx, em_mom=CONFIG["em_mom"],
                                          donate=False,
                                          compute_dtype="bfloat16" if dtype == "bfloat16" else None)
            state, out = step(state, {"images": cast(_images()),
                                      "segmented": jnp.asarray(_labels())},
                              jax.random.PRNGKey(0))
        new = {"params": jax.tree_util.tree_map(np.asarray, state.params),
               "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
        return new, np.asarray(state.extra), float(out["softmax"])


def _jax_step(dtype):
    """`_jax_step_flax` as the port's state dict (float32) and the loss."""
    new, mu, loss = _jax_step_flax(dtype)
    return ema_net_params_from_jax(new, mu), loss


def _port_step(dtype="float32"):
    """The port's step from `_variables`: float32 state computing in
    `dtype` ("float32", "bfloat16"), or everything in "float64"."""
    variables, mu = _variables()
    net = _port(variables, mu)
    net.dropout = 0.0
    wide = torch.float64 if dtype == "float64" else torch.float32
    net.to(wide)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    out = emanet_train_step(
        net, _port_optimizer(net),
        {"images": torch.from_numpy(_images()).permute(0, 3, 1, 2).to(wide),
         "segmented": torch.from_numpy(_labels()).long()},
        CONFIG["em_mom"], torch.bfloat16 if dtype == "bfloat16" else None)
    return net, before, float(out["softmax"])


def _exact_step():
    """The JAX float64 step's new state dict (the reference updates)."""
    return _jax_step("float64")[0]


def test_float64_step_matches_jax_float64():
    """Without float32's rounding the step is well conditioned: the port's
    gradients, decay, parameter groups, momentum, BatchNorm statistics and
    µ against the JAX package's, tightly."""
    want, want_mu, ref_loss = _jax_step_flax("float64")
    net, before, loss = _port_step("float64")
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)

    def flax(sd):
        return torch_emanet_to_flax({k: v.numpy() for k, v in sd.items()})

    got, start = flax(net.state_dict()), flax(before)
    leaves = list(zip(jax.tree_util.tree_leaves_with_path(want["params"]),
                      jax.tree_util.tree_leaves(got["params"]),
                      jax.tree_util.tree_leaves(start["params"])))
    assert len(leaves) == len(list(net.parameters()))
    for (path, ref), value, first in leaves:
        assert ref.dtype == value.dtype == np.float64
        update = np.linalg.norm(ref - first)
        assert update > 0 or jax.tree_util.keystr(path) == "['emau']['conv1']['bias']"
        assert np.linalg.norm(value - ref) <= 1e-6 * update + 1e-12, jax.tree_util.keystr(path)
    for (path, ref), value in zip(jax.tree_util.tree_leaves_with_path(want["batch_stats"]),
                                  jax.tree_util.tree_leaves(got["batch_stats"])):
        assert _rel(value, ref) <= 1e-10, jax.tree_util.keystr(path)
    assert _rel(got["mu"], want_mu) <= 1e-7


def _distances(got, want, before, names):
    """(L2 of all updates' differences / L2 of `want`'s updates, the worst
    tensor's L2 of its updates' difference / (L2 of `want`'s update + what
    rounding each new value to float32 may add)."""
    d_got = torch.cat([(got[n] - before[n]).flatten().double() for n in names])
    d_want = torch.cat([(want[n] - before[n]).flatten().double() for n in names])
    worst = 0.0
    for n in names:
        diff = float((got[n] - want[n]).double().norm())
        rounding = float(torch.finfo(torch.float32).eps * before[n].double().norm())
        worst = max(worst, diff / (float((want[n] - before[n]).double().norm()) + rounding))
    return float((d_got - d_want).norm() / d_want.norm()), worst


def test_float32_step_matches_jax():
    want, ref_loss = _jax_step("float32")
    net, before, loss = _port_step()
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    got = net.state_dict()
    params = [n for n, _ in net.named_parameters()]
    for name, ref_value in want.items():
        if name in params or name.endswith("num_batches_tracked"):
            continue  # running statistics and µ
        assert _rel(got[name].numpy(), ref_value.numpy()) <= 1e-4, name
    assert not torch.equal(got["emau.mu"], before["emau.mu"])
    exact = _exact_step()
    port_l2, port_worst = _distances(got, exact, before, params)
    jax_l2, jax_worst = _distances(want, exact, before, params)
    assert port_l2 <= 1.5 * jax_l2, (port_l2, jax_l2)
    assert port_worst <= 1.5 * jax_worst, (port_worst, jax_worst)
    # emau.conv1 has no gradient: its weight decays as optax decays it, its
    # bias (no decay) stays
    lr0 = schedules.segmentation_lr_schedule(CONFIG, PER_EPOCH)(0)
    w0 = before["emau.conv1.weight"]
    decayed = w0 - lr0 * CONFIG["weight_decay"] * w0
    for sd in (got, want):
        torch.testing.assert_close(sd["emau.conv1.weight"], decayed, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(sd["emau.conv1.bias"], before["emau.conv1.bias"],
                                   rtol=0, atol=0)


def test_bfloat16_step_as_close_as_jax_bfloat16():
    want16, loss16 = _jax_step("bfloat16")
    net, before, loss = _port_step("bfloat16")
    got = net.state_dict()
    assert all(v.dtype == torch.float32 for v in got.values() if v.is_floating_point())
    params = [n for n, _ in net.named_parameters()]
    exact = _exact_step()
    port_l2, port_worst = _distances(got, exact, before, params)
    jax_l2, jax_worst = _distances(want16, exact, before, params)
    assert port_l2 <= 2 * jax_l2, (port_l2, jax_l2)
    assert port_worst <= 2 * jax_worst, (port_worst, jax_worst)
    # the loss too, against float64's: the JAX bfloat16 loss sits 6.5 % from
    # it, the port's 1.2 % (their roundings differ, so port - JAX is not the
    # measure)
    exact_loss = _jax_step("float64")[1]
    assert abs(loss - exact_loss) <= 2 * abs(loss16 - exact_loss), (loss, loss16, exact_loss)
    mu_port = _rel(got["emau.mu"].numpy(), exact["emau.mu"].numpy())
    mu_jax = _rel(want16["emau.mu"].numpy(), exact["emau.mu"].numpy())
    assert mu_port <= 2 * mu_jax + 1e-6, (mu_port, mu_jax)


def test_sgd_groups_match_optax_over_three_steps():
    variables, mu = _variables()
    net = _port(variables, mu)
    opt = _port_optimizer(net)
    names = {id(p): n for n, p in net.named_parameters()}
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    norms = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    groups = opt.sgd.param_groups
    assert [len(g["params"]) for g in groups] == [
        len(convs), len(norms), len(norms) + sum(c.bias is not None for c in convs)]
    assert [(g["weight_decay"], g["lr_scale"]) for g in groups] == [
        (CONFIG["weight_decay"], 1.0), (0.0, 1.0), (0.0, 2.0)]
    assert len(opt.params) == len(names)
    tx = _jax_tx()
    update = jax.jit(tx.update)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    rs = np.random.RandomState(9)
    state_dict = net.state_dict()
    for _ in range(3):
        grads = {n: rs.randn(*p.shape).astype(np.float32) for n, p in net.named_parameters()}
        grads["emau.conv1.weight"] = np.zeros_like(grads["emau.conv1.weight"])
        grads["emau.conv1.bias"] = np.zeros_like(grads["emau.conv1.bias"])
        flax_grads = torch_emanet_to_flax({**{k: v.numpy() for k, v in state_dict.items()},
                                           **grads})["params"]
        updates, opt_state = update(jax.tree_util.tree_map(jnp.asarray, flax_grads),
                                    opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step([None if names[id(p)].startswith("emau.conv1.")
                  else torch.from_numpy(grads[names[id(p)]]) for p in opt.params])
    want = ema_net_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, params),
                                    "batch_stats": variables["batch_stats"]}, mu)
    for name, value in net.named_parameters():
        np.testing.assert_allclose(value.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert opt.count == 3


def test_page_matches_jax_on_its_init_mu():
    """The JAX segmenter applies the network without µ, so its pages run on
    `init_emau_mu(C, K, 0)`; the port's pages use the buffer, set to that µ
    here (tests/test_torch_ema_net_cli.py shows a snapshot's µ reaching the
    page path)."""
    model = _jax_model()
    variables, _ = _variables()
    init_mu = np.asarray(jax_ema.init_emau_mu(EMAU_C, EMAU_K, 0))
    net = _port(variables, init_mu).eval()
    common = dict(class_to_color_map=COLORS, config={"image_size": 32, "batch_size": 3},
                  patch_overlap_factor=0.25, use_device_component_filter=True)
    ref = jax_seg.AnalysisSegmenter(
        None, network=model, network_variables={"params": variables["params"],
                                                "batch_stats": variables["batch_stats"]},
        segmenter_config=JaxSegmenterConfig(NUM_CLASSES, min_confidence=0.4,
                                            min_contour_area=5), **common)
    ours = seg.AnalysisSegmenter(
        None, network=net, segmenter_config=SegmenterConfig(NUM_CLASSES, min_confidence=0.4,
                                                            min_contour_area=5),
        device="cpu", **common)
    page = _page()
    want = ref.segment_image(page)
    got = ours.segment_image(page)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    agree = (ours.segment_image_classes(page) == ref.segment_image_classes(page)).mean()
    assert agree >= 0.999, agree


@pytest.mark.parametrize("n_layers", [101, 152])
def test_deeper_backbones_match_the_jax_layout(n_layers):
    """ResNet-101 and -152: the port's state dict, read by the JAX
    package's `torch_emanet_to_flax`, has the JAX module's parameter and
    statistics shapes (its init traced with `jax.eval_shape`, not run)."""
    model = jax_ema.EMANet(num_classes=NUM_CLASSES, n_layers=n_layers, emau_channels=EMAU_C,
                           emau_k=EMAU_K)
    shapes = jax.eval_shape(lambda k: model.init({"params": k, "dropout": k},
                                                 jnp.zeros((1, 32, 32, 3))),
                            jax.random.PRNGKey(0))
    net = EMANet(NUM_CLASSES, n_layers=n_layers, emau_channels=EMAU_C, emau_k=EMAU_K)
    back = torch_emanet_to_flax({k: v.numpy() for k, v in net.state_dict().items()})
    for collection in ("params", "batch_stats"):
        want = jax.tree_util.tree_map(lambda a: a.shape, shapes[collection])
        got = jax.tree_util.tree_map(lambda a: a.shape, back[collection])
        assert got == want, collection
    assert back["mu"].shape == (1, EMAU_C, EMAU_K)
