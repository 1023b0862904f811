"""The port's DocUFCN against the JAX package's on the CPU, eval mode, with
weights from JAX `init` (BatchNorm parameters and statistics randomized so
that the normalization is exercised) carried across by
`doc_ufcn_params_from_jax`. Feature sizes (8, 16, 32), batch 2, 32x32.
Tolerance rtol 1e-4 / atol 1e-5: float32, the same convolutions summed in
another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models.doc_ufcn import get_doc_ufcn as jax_get_doc_ufcn
from synthesis_in_style_tpu.utils.checkpoint import torch_doc_ufcn_to_flax
from synthesis_in_style_tpu_torch.models.doc_ufcn import BatchNorm2d, DocUFCN, get_doc_ufcn
from synthesis_in_style_tpu_torch.utils.checkpoint import doc_ufcn_params_from_jax
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FEATURES = (8, 16, 32)
NUM_CLASSES = 3


def _randomize_bn(variables, seed=1):
    """BatchNorm scale/bias and running statistics drawn from a seeded
    numpy generator (fresh init normalizes to the identity)."""
    rs = np.random.default_rng(seed)

    def walk(params, stats):
        for name, sub in params.items():
            if name == "bn":
                c = sub["scale"].shape
                sub["scale"] = (1.0 + 0.2 * rs.standard_normal(c)).astype(np.float32)
                sub["bias"] = (0.1 * rs.standard_normal(c)).astype(np.float32)
                stats[name]["mean"] = (0.3 * rs.standard_normal(c)).astype(np.float32)
                stats[name]["var"] = (rs.random(c) + 0.5).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, stats.get(name, {}))

    walk(variables["params"], variables["batch_stats"])
    return variables


def jax_variables(version="base", seed=0, **kwargs):
    model = jax_get_doc_ufcn(version)(num_classes=NUM_CLASSES, feature_sizes=FEATURES, **kwargs)
    x = jnp.zeros((1, 32, 32, 3))
    variables = model.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                           x, train=False)
    variables = jax.tree_util.tree_map(lambda a: np.array(a), dict(variables))
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    return model, _randomize_bn(variables)


def port_model(version, variables):
    net = get_doc_ufcn(version)(num_classes=NUM_CLASSES, feature_sizes=FEATURES)
    net.load_state_dict(doc_ufcn_params_from_jax(variables), strict=True)
    return net.eval()


def _inputs():
    return np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)


def _port_forward(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("version", ["base", "pixelshuffle", "no_dropout"])
def test_forward_matches_jax(version):
    model, variables = jax_variables(version)
    x = _inputs()
    ref = np.asarray(model.apply(variables, x, train=False))
    got = _port_forward(port_model(version, variables), x)
    assert got.shape == ref.shape == (2, 32, 32, NUM_CLASSES)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s2d", [dict(s2d_stem=1, s2d_tail=True), dict(s2d_stem=2)])
def test_plain_port_matches_jax_s2d_relowering(s2d):
    """The JAX space-to-depth stem and tail keep the parameter tree and
    compute the same function; the port computes the plain layout."""
    model, variables = jax_variables("base", **s2d)
    x = _inputs()
    ref = np.asarray(model.apply(variables, x, train=False))
    got = _port_forward(port_model("base", variables), x)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_round_trip_through_torch_doc_ufcn_to_flax():
    _, variables = jax_variables("base")
    sd = doc_ufcn_params_from_jax(variables)
    back = torch_doc_ufcn_to_flax({k: v.numpy() for k, v in sd.items()
                                   if not k.endswith("num_batches_tracked")})
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)


def test_reference_keys_and_config_keys():
    net = DocUFCN(num_classes=3)
    keys = set(net.state_dict())
    for key in ("encoder_blocks.0.0.conv.weight", "encoder_blocks.3.4.bn.running_var",
                "decoder_blocks.2.conv.bn.weight", "decoder_blocks.0.upsample.conv.weight",
                "classifier.bias"):
        assert key in keys, key
    assert net.decoder_blocks[0].upsample.conv.weight.shape == (128, 128, 2, 2)
    DocUFCN(num_classes=3, s2d_stem=1, s2d_tail=True)  # accepted, plain layout
    # remat (once unported) keeps the parameter and buffer layout
    assert set(DocUFCN(num_classes=3, remat=True).state_dict()) == keys
    with pytest.raises(NotImplementedError):
        get_doc_ufcn("unet")


def test_batchnorm_running_variance_is_biased_like_flax():
    """n = B * H * W = 8 here, where torch's unbiased update would differ
    by 8/7."""
    bn = BatchNorm2d(4).train()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 2, 2)).astype(np.float32))
    bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    mean = x.mean(dim=(0, 2, 3))
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=0, atol=1e-6)


def test_init_weights_is_lecun_normal():
    net = DocUFCN(num_classes=3).init_weights(torch.Generator().manual_seed(0))
    w = net.encoder_blocks[1][1].conv.weight
    fan_in = w[0].numel()
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 0.8796256610342398 / np.sqrt(fan_in) + 1e-6
    assert float(net.classifier.bias.abs().sum()) == 0.0


def _train_step(net, x, weights, seed):
    """One train-mode forward and backward of sum(logits * weights), dropout
    drawn from `seed`: the gradients by state-dict key."""
    net.train()
    net.zero_grad()
    torch.manual_seed(seed)
    (net(x) * weights).sum().backward()
    return {k: p.grad.clone() for k, p in net.named_parameters()}


@pytest.mark.parametrize("version", ["base", "pixelshuffle"])
def test_remat_gradients_equal_and_running_stats_move_once(version):
    """remat: true recomputes each block in the backward: the same dropout
    masks (RNG state preserved), the same gradients (1e-6 relative), and
    BatchNorm's running statistics updated once per step, as without it."""
    _, variables = jax_variables(version)
    plain = port_model(version, variables)
    remat = get_doc_ufcn(version)(num_classes=NUM_CLASSES, feature_sizes=FEATURES, remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_inputs()).permute(0, 3, 1, 2)
    weights = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, NUM_CLASSES, 32, 32)).astype(np.float32))
    for seed in (0, 1):  # two steps: the second starts from moved statistics
        g_plain = _train_step(plain, x, weights, seed)
        g_remat = _train_step(remat, x, weights, seed)
        for k, ref in g_plain.items():
            err = (g_remat[k] - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
            assert err <= 1e-6, (k, float(err))
    for k, ref in plain.state_dict().items():
        torch.testing.assert_close(remat.state_dict()[k], ref, rtol=0, atol=0, msg=k)
    assert int(remat.encoder_blocks[0][0].bn.num_batches_tracked) == 2


def test_remat_gradients_match_jax_remat():
    """The port's remat step against the JAX package's `remat=True` step, in
    float64 on both sides (no dropout: the two packages draw other masks):
    every gradient within 1e-6 of its tensor's largest; a conv bias that
    feeds train-mode BatchNorm has an exact gradient of 0 (the batch mean
    removes it), so its rounding noise is held to 1e-6 of the step's largest."""
    from synthesis_in_style_tpu_torch.utils.checkpoint import doc_ufcn_params_from_jax as conv

    model, variables = jax_variables("no_dropout", remat=True)
    x = _inputs()
    weights = np.random.default_rng(4).standard_normal((2, 32, 32, NUM_CLASSES))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss(params):
            logits, _ = model.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                    jnp.asarray(x, jnp.float64), train=True,
                                    mutable=["batch_stats"])
            return jnp.sum(logits * weights)

        grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(v64["params"]))
    ref = conv({"params": grads, "batch_stats": variables["batch_stats"]})
    net = get_doc_ufcn("no_dropout")(num_classes=NUM_CLASSES, feature_sizes=FEATURES,
                                      remat=True)
    net.load_state_dict(doc_ufcn_params_from_jax(variables))
    net.double()
    got = _train_step(net, torch.from_numpy(x).double().permute(0, 3, 1, 2),
                      torch.from_numpy(weights).permute(0, 3, 1, 2), 0)
    assert sorted(got) == sorted(k for k in ref if not k.startswith(("bn", "num")) and
                                 "running" not in k and "num_batches" not in k)
    largest = max(float(r.abs().max()) for r in ref.values() if r.is_floating_point())
    for k, g in got.items():
        r = ref[k].double()
        scale = largest if k.endswith("conv.bias") else r.abs().max()
        assert (g - r).abs().max() <= 1e-6 * scale, k
