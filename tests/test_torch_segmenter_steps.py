"""The port's DocUFCN training step, losses, metrics and learning-rate
schedules against the JAX package's on the CPU.

One standard (weighted cross-entropy) step of the `no_dropout` DocUFCN in
float32, from the same converted weights on the same batch: the loss within
1e-5, every parameter after clip, weight decay and Adam within 1e-4 of the
largest reference parameter, and the BatchNorm running means and variances
within 1e-5 (flax updates the variance with the biased batch variance; at
the bottom of this net n = B * h * w = 8, where torch's own unbiased update
would be off by 8/7). The dropout streams of JAX and torch differ, so the
step runs the `no_dropout` variant. The biases of the convolutions that feed
BatchNorm are the exception: their gradient is rounding noise (zero in exact
arithmetic), so both sides may move them by up to the learning rate.

The same step in bfloat16 (`compute_dtype="bfloat16"` on both sides: every
floating parameter cast, BatchNorm's scale and bias included) is held to
what bfloat16 convolutions summed in another order allow: the loss within
1e-3 of its value, the running statistics within 1e-3, and Adam's first
step, which moves every element by about lr times the sign of its gradient,
differing by more than lr / 10 on at most 10 % of the elements (the signs of
gradients within bfloat16 rounding of 0 differ; measured 8.8 % with one
torch thread, and 13.6 % when BatchNorm's parameters stayed float32). The
classifier's gradients are large, so its update agrees within 1e-3 of lr."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthesis_in_style_tpu.core import schedules as jax_schedules
from synthesis_in_style_tpu.evaluation import metrics as jax_metrics
from synthesis_in_style_tpu.losses import segmentation as jax_losses
from synthesis_in_style_tpu.training_builder.base import BaseTrainBuilder as JaxBuilder
from synthesis_in_style_tpu.updaters.segmentation_updater import (
    SegTrainState,
    make_standard_train_step,
)
from synthesis_in_style_tpu_torch.core import schedules
from synthesis_in_style_tpu_torch.evaluation import metrics
from synthesis_in_style_tpu_torch.losses import segmentation as losses
from synthesis_in_style_tpu_torch.updaters.segmentation_updater import (
    cast_params,
    standard_train_step,
)
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import GANOptimizer
from synthesis_in_style_tpu_torch.utils.checkpoint import doc_ufcn_params_from_jax
from test_torch_doc_ufcn import jax_variables, port_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CONFIG = {"lr": 0.005, "weight_decay": 0.0001, "end_lr": 1e-8, "cosine_max_update_epoch": 2,
          "beta1": 0.5, "beta2": 0.999}
CLASS_WEIGHTS = [0.5, 1.0, 2.0]


def _batch(seed=4):
    rs = np.random.default_rng(seed)
    images = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    labels = rs.integers(0, 3, (2, 32, 32)).astype(np.int32)
    return images, labels


def _both_steps(compute_dtype=None):
    """One step of the JAX package and one of the port from the same
    converted weights and batch: (loss ref, loss port, ref state dict,
    port network, weights before, lr of the step)."""
    model, variables = jax_variables("no_dropout")
    images, labels = _batch()
    per_epoch = 5
    jax_schedule = JaxBuilder.lr_schedule(SimpleNamespace(
        config=CONFIG, train_data_loader=[None] * per_epoch, _base_lr=lambda: CONFIG["lr"]))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.add_decayed_weights(CONFIG["weight_decay"]),
                     optax.adam(jax_schedule, b1=CONFIG["beta1"], b2=CONFIG["beta2"]))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = SegTrainState(params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    step = make_standard_train_step(model, tx, class_weights=jnp.asarray(CLASS_WEIGHTS),
                                    donate=False, compute_dtype=compute_dtype)
    state, jax_out = step(state, {"images": jnp.asarray(images),
                                  "segmented": jnp.asarray(labels)}, jax.random.PRNGKey(0))
    ref = doc_ufcn_params_from_jax({
        "params": jax.tree_util.tree_map(np.asarray, state.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)})

    net = port_model("no_dropout", variables).train()
    opt = GANOptimizer(net.parameters(), schedules.segmentation_lr_schedule(CONFIG, per_epoch),
                       (CONFIG["beta1"], CONFIG["beta2"]), weight_decay=CONFIG["weight_decay"])
    out = standard_train_step(net, opt, {"images": torch.from_numpy(images).permute(0, 3, 1, 2),
                                         "segmented": torch.from_numpy(labels).long()},
                              torch.tensor(CLASS_WEIGHTS),
                              getattr(torch, compute_dtype) if compute_dtype else None)
    lr0 = schedules.segmentation_lr_schedule(CONFIG, per_epoch)(0)
    return (float(jax_out["softmax"]), float(out["softmax"]), ref, net,
            doc_ufcn_params_from_jax(variables), lr0)


def test_bfloat16_training_step_matches_jax():
    ref_loss, loss, want, net, before, lr0 = _both_steps("bfloat16")
    assert abs(loss - ref_loss) <= 1e-3 * abs(ref_loss)
    got = net.state_dict()
    param_names = {n for n, _ in net.named_parameters()}
    off = total = 0
    for name, ref_value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = (got[name] - ref_value).abs()
        if name in param_names:
            for value in (got[name], ref_value):  # Adam's first step: at most lr
                assert float((value - before[name]).abs().max()) <= lr0 * (1 + 1e-4), name
            off += int((diff > 0.1 * lr0).sum())
            total += diff.numel()
            if name.startswith("classifier."):
                assert float(diff.max()) <= 1e-3 * lr0, name
        else:  # BatchNorm running mean / variance
            assert float(diff.max()) <= 1e-3, (name, float(diff.max()))
    assert off <= 0.10 * total, off / total

    # every floating parameter is cast; BatchNorm's rounded, in float32
    cast = cast_params(net, torch.bfloat16)
    assert set(cast) == param_names
    for name, value in cast.items():
        if ".bn." in name:
            assert value.dtype == torch.float32
            assert torch.equal(value, net.state_dict()[name].bfloat16().float())
        else:
            assert value.dtype == torch.bfloat16


def test_one_training_step_matches_jax():
    ref_loss, loss, want, net, before, lr0 = _both_steps()
    assert abs(loss - ref_loss) <= 1e-5
    got = net.state_dict()
    param_names = {n for n, _ in net.named_parameters()}
    scale = max(float(want[n].abs().max()) for n in param_names)
    checked = 0
    for name, ref_value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        err = float((got[name] - ref_value).abs().max())
        if name.endswith(".conv.bias"):
            # the bias of a convolution that feeds train-mode BatchNorm has
            # a zero gradient in exact arithmetic; its float32 gradient is
            # rounding noise, which Adam's first step turns into a move of
            # up to lr either way in both implementations
            for value in (got[name], ref_value):
                assert float((value - before[name]).abs().max()) <= lr0 * (1 + 1e-5), name
        elif name in param_names:
            assert err <= 1e-4 * scale, (name, err, scale)
            checked += 1
        else:  # BatchNorm running mean / variance
            assert err <= 1e-5, (name, err)
    assert checked == len(param_names) - sum(n.endswith(".conv.bias") for n in param_names)


def test_lr_schedules_match_jax():
    per_epoch = 5
    ours = schedules.segmentation_lr_schedule(CONFIG, per_epoch)
    ref = JaxBuilder.lr_schedule(SimpleNamespace(
        config=CONFIG, train_data_loader=[None] * per_epoch, _base_lr=lambda: CONFIG["lr"]))
    pairs = [(ours, ref),
             (schedules.cosine_warm_restarts(1e-3, 4, 1, 1e-6),
              jax_schedules.cosine_warm_restarts(1e-3, 4, 1, 1e-6)),
             (schedules.cosine_warm_restarts(1e-3, 3, 2, 1e-6),
              jax_schedules.cosine_warm_restarts(1e-3, 3, 2, 1e-6)),
             (schedules.constant(3e-4), jax_schedules.constant(3e-4))]
    for mine, theirs in pairs:
        for s in range(10):
            assert mine(s) == pytest.approx(float(theirs(s)), rel=1e-5, abs=1e-12), s
    warm = schedules.segmentation_lr_schedule({**CONFIG, "warm_restarts": True}, per_epoch)
    assert warm(10) == pytest.approx(CONFIG["lr"])  # cosine_end 10: a new cycle
    no_cosine = schedules.segmentation_lr_schedule(
        {"lr": 1e-3, "cosine_max_update_iter": 0}, per_epoch)
    assert no_cosine(7) == 1e-3


@pytest.mark.parametrize("weights", [None, CLASS_WEIGHTS])
def test_cross_entropy_matches_jax(weights):
    rs = np.random.default_rng(5)
    logits = rs.standard_normal((2, 9, 7, 3)).astype(np.float32) * 3
    labels = rs.integers(0, 3, (2, 9, 7))
    ref = float(jax_losses.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if weights is None else jnp.asarray(weights)))
    got = float(losses.cross_entropy_loss(
        torch.from_numpy(logits).permute(0, 3, 1, 2), torch.from_numpy(labels),
        None if weights is None else torch.tensor(weights)))
    assert abs(got - ref) <= 1e-6


def test_dice_loss_matches_jax():
    rs = np.random.default_rng(6)
    logits = rs.standard_normal((2, 9, 7, 4)).astype(np.float32)
    labels = rs.integers(0, 4, (2, 9, 7))
    for softmax in (True, False):
        ref = float(jax_losses.dice_loss(jnp.asarray(logits), jnp.asarray(labels), 4, softmax))
        got = float(losses.dice_loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                     torch.from_numpy(labels), 4, softmax))
        assert abs(got - ref) <= 1e-6


@pytest.mark.parametrize("metric", ["dice", "iou", "precision", "recall"])
def test_confusion_matrix_and_metrics_identical(metric):
    rs = np.random.default_rng(7)
    gt = rs.integers(0, 3, (3, 20, 30))
    pred = np.where(rs.random(gt.shape) < 0.7, gt, rs.integers(0, 3, gt.shape))
    pred[pred == 2] = 1  # a class that is never predicted
    names = ["background", "printed_text", "handwritten_text"]
    cm = metrics.calculate_confusion_matrix(torch.from_numpy(gt), torch.from_numpy(pred), 3)
    ref_cm = jax_metrics.calculate_confusion_matrix(gt, pred, 3)
    np.testing.assert_array_equal(cm, ref_cm)
    assert metrics.calculate_metric(cm, names, metric) == \
        jax_metrics.calculate_metric(ref_cm, names, metric)
    empty = np.zeros((3, 3))
    empty[0, 0] = 5  # no text anywhere: text scores 1.0
    assert metrics.calculate_metric(empty, names, metric) == \
        jax_metrics.calculate_metric(empty, names, metric)


def test_segmentation_grid_matches_jax():
    from synthesis_in_style_tpu.visualization.segmentation_plotter import (
        render_segmentation_grid as jax_render,
    )
    from synthesis_in_style_tpu_torch.visualization.segmentation_plotter import (
        render_segmentation_grid,
    )

    rs = np.random.default_rng(8)
    inputs = rs.uniform(-1, 1, (3, 12, 10, 3)).astype(np.float32)
    labels = rs.integers(0, 3, (3, 12, 10))
    scores = rs.random((3, 12, 10, 3)).astype(np.float32)
    colors = {"background": "#000000", "printed_text": "#0000ff", "handwritten_text": "#ff0000"}
    np.testing.assert_array_equal(render_segmentation_grid(inputs, labels, scores, colors),
                                  np.asarray(jax_render(inputs, labels, scores, colors)))
