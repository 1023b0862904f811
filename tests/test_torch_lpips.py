"""The port's LPIPS, perceptual / style losses and LPIPS rank training
against the JAX package's on the CPU, on 32px images from numpy. The
backbones are the JAX package's seeded random inits carried across (no
ImageNet weights are in the repo; the values are uncalibrated on both
sides). Tolerance: 1e-4 of the reference's max |value| for forwards and
for parameters after a step (float32 both sides)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.losses import lpips as jlpips
from synthesis_in_style_tpu.losses import lpips_rank as jrank
from synthesis_in_style_tpu.losses import perceptual as jperc
from synthesis_in_style_tpu_torch.losses import lpips as tlpips
from synthesis_in_style_tpu_torch.losses import lpips_rank as trank
from synthesis_in_style_tpu_torch.losses import perceptual as tperc
from synthesis_in_style_tpu_torch.utils.checkpoint import vgg16_features_params_from_jax

from tests.torch_autoencoder_fixtures import assert_close, images, lpips_pair, numpy_tree
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax(net):
    jl, tl = lpips_pair(net)
    a, b = images(seed=1), images(seed=2)
    ref = jax.jit(lambda a, b: jl(a, b))(jnp.asarray(a), jnp.asarray(b))
    got = tl(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2,)
    assert_close(got, ref, f"lpips {net}")
    ref01 = jl(jnp.asarray(a * 0.5 + 0.5), jnp.asarray(b * 0.5 + 0.5), normalize=True)
    assert_close(tl(torch.from_numpy(a * 0.5 + 0.5), torch.from_numpy(b * 0.5 + 0.5),
                    normalize=True), ref01, f"lpips {net} normalize")
    assert not any(p.requires_grad for p in tl.parameters())
    # gradients reach the inputs
    x = torch.from_numpy(a).requires_grad_(True)
    tl(x, torch.from_numpy(b)).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("version", ["0.0", "0.1"])
def test_vendored_lin_weights_equal_the_jax_package(version):
    for net in ("alex", "vgg", "squeeze"):
        ours = tlpips.load_vendored_lpips_lin(net, version)
        theirs = jlpips.load_vendored_lpips_lin(net, version)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        ref_dir = jlpips.VENDORED_LIN_DIR / f"v{version}" / f"{net}.npz"
        ours_file = tlpips.VENDORED_LIN_DIR / f"v{version}" / f"{net}.npz"
        assert ours_file.read_bytes() == ref_dir.read_bytes()
    assert "synthesis_in_style_tpu_torch" in str(tlpips.VENDORED_LIN_DIR)


def test_random_backbone_warns_and_env_weights_load(tmp_path, monkeypatch):
    from synthesis_in_style_tpu.utils.checkpoint import save_pytree_npz

    monkeypatch.delenv("SIS_METRIC_WEIGHTS", raising=False)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        assert not tlpips.LPIPS("alex").calibrated_backbone
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jl = jlpips.LPIPS("vgg")
    save_pytree_npz(tmp_path / "vgg_features.npz", numpy_tree(jl.variables["params"]))
    monkeypatch.setenv("SIS_METRIC_WEIGHTS", str(tmp_path))
    tl = tlpips.LPIPS("vgg")
    assert tl.calibrated_backbone
    a, b = images(seed=3), images(seed=4)
    assert_close(tl(torch.from_numpy(a), torch.from_numpy(b)), jl(jnp.asarray(a), jnp.asarray(b)),
                 "lpips from SIS_METRIC_WEIGHTS")


def _perceptual_pair(**kwargs):
    jp = jperc.PerceptualAndStyleLoss(**kwargs)
    tp = tperc.PerceptualAndStyleLoss(
        state=vgg16_features_params_from_jax(numpy_tree(jp.variables["params"])), **kwargs)
    return jp, tp


@pytest.mark.parametrize("masked", [False, True])
def test_perceptual_and_style_loss_matches_jax(masked):
    jp, tp = _perceptual_pair()
    a, b = images(seed=5), images(seed=6)
    mask = (images(seed=7, channels=1) > 0).astype(np.float32) if masked else None
    ref_style, ref_perc = jax.jit(lambda a, b, m: jp(a, b, m))(
        jnp.asarray(a), jnp.asarray(b), None if mask is None else jnp.asarray(mask))
    style, perc = tp(torch.from_numpy(a), torch.from_numpy(b),
                     None if mask is None else torch.from_numpy(mask))
    assert_close(perc, ref_perc, "perceptual")
    assert_close(style, ref_style, "style")
    # the StyleLossNetwork is the style half alone
    net = tperc.StyleLossNetwork(state=tp.vgg.state_dict())
    assert_close(net(torch.from_numpy(a), torch.from_numpy(b)),
                 jperc.StyleLossNetwork(jp.variables)(jnp.asarray(a), jnp.asarray(b)), "style net")


def test_gram_and_losses_match_jax():
    rs = np.random.RandomState(0)
    feats = rs.randn(2, 8, 8, 5).astype(np.float32)
    target = rs.randn(2, 8, 8, 5).astype(np.float32)
    mask = rs.rand(2, 8, 8, 1).astype(np.float32)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    assert_close(tperc.gram_matrix(nchw(feats), nchw(mask)),
                 jperc.gram_matrix(jnp.asarray(feats), jnp.asarray(mask)), "gram")
    assert_close(tperc.style_loss(nchw(feats), nchw(target), nchw(mask)),
                 jperc.style_loss(jnp.asarray(feats), jnp.asarray(target), jnp.asarray(mask)),
                 "style")
    assert_close(tperc.perceptual_loss(nchw(feats), nchw(target), nchw(mask)),
                 jperc.perceptual_loss(jnp.asarray(feats), jnp.asarray(target),
                                       jnp.asarray(mask)), "perceptual")
    assert_close(tperc.euclidean_distance(nchw(feats), nchw(target), nchw(mask)),
                 jperc.euclidean_distance(jnp.asarray(feats), jnp.asarray(target),
                                          jnp.asarray(mask)), "euclidean")


def test_lpips_rank_pieces_and_one_trainer_step():
    rs = np.random.RandomState(1)
    d0, d1 = rs.rand(6).astype(np.float32), rs.rand(6).astype(np.float32)
    judge = rs.rand(6).astype(np.float32)
    layer = jrank.Dist2LogitLayer()
    params = layer.init(jax.random.PRNGKey(0), jnp.zeros((1,)), jnp.zeros((1,)))
    port = trank.Dist2LogitLayer()
    port.load_state_dict(trank.dist2logit_params_from_jax(numpy_tree(params)))
    prob = port(torch.from_numpy(d0), torch.from_numpy(d1))
    assert_close(prob, layer.apply(params, jnp.asarray(d0), jnp.asarray(d1)), "rank head")
    assert_close(trank.bce_ranking_loss(prob, torch.from_numpy(judge * 2 - 1)),
                 jrank.bce_ranking_loss(jnp.asarray(prob.detach().numpy()),
                                        jnp.asarray(judge * 2 - 1)), "bce")
    assert_close(trank.compute_accuracy(torch.from_numpy(d0), torch.from_numpy(d1),
                                        torch.from_numpy(judge)),
                 jrank.compute_accuracy(jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(judge)),
                 "accuracy")
    assert trank.twoafc_score(d0, d1, judge) == jrank.twoafc_score(d0, d1, judge)

    jl, tl = lpips_pair("alex")
    jt = jrank.LPIPSRankTrainer(jl, lr=1e-3)
    tt = trank.LPIPSRankTrainer(tl, lr=1e-3)
    tt.rank_net.load_state_dict(trank.dist2logit_params_from_jax(numpy_tree(jt.params["rank"])))
    ref, p0, p1 = images(seed=11), images(seed=12), images(seed=13)
    j01 = np.array([0.2, 0.9], np.float32)
    jm = jt.train_step(ref, p0, p1, j01)
    tm = tt.train_step(*(torch.from_numpy(a) for a in (ref, p0, p1)), j01)
    assert abs(tm["loss_total"] - jm["loss_total"]) <= 1e-4 * abs(jm["loss_total"])
    assert tm["acc_r"] == jm["acc_r"]
    lin_scale = max(float(np.abs(np.asarray(w)).max()) for w in jt.params["lin"])
    for k, (got, want) in enumerate(zip(tt.lin, jt.params["lin"])):
        assert_close(got, want, f"lin {k}", scale=lin_scale)
        assert float(got.min()) >= 0.0
    want_rank = trank.dist2logit_params_from_jax(numpy_tree(jt.params["rank"]))
    rank_scale = max(float(v.abs().max()) for v in want_rank.values())
    for key, value in want_rank.items():
        assert_close(tt.rank_net.state_dict()[key], value.numpy(), key, scale=rank_scale)
    tt.apply_to_lpips()
    assert torch.equal(tl.lin0, tt.lin[0].detach())
    ev = tt.evaluate(*(torch.from_numpy(a) for a in (ref, p0, p1)), j01)
    assert 0.0 <= ev["twoafc"] <= 1.0
