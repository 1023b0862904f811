"""The port's static w8a8 DocUFCN (synthesis_in_style_tpu_torch/models/
doc_ufcn_quant.py) against the JAX package's models/doc_ufcn_quant.py on the
CPU, with the JAX weights carried across by `doc_ufcn_params_from_jax`.

* `calibrate`: the abs-max of every site, key by key. Both packages run in
  float64 here (and cast each abs-max to float32, as both do), so the sites
  are held to 1e-6 relative; in float32 the two forwards differ by summation
  order at ~1e-5 of a deep layer's range.
* `pack_quant`: from the same scales, the int8 weights are identical and the
  float32 epilogue vectors equal to float32 rounding.
* `quantized_forward`: from the same packed tree, class maps agree on at
  least 0.999 of the pixels and logits within 1e-2 of max|ref|. The int8
  activations between layers are requantized float results, so a value
  within rounding of a .5 boundary can land one step apart; the share of
  such flips is measured at the output of every int8 conv the forward runs.

The port's pixel-shuffle conv orders its 4F channels as (channel, parity);
JAX as (parity, channel). `_jax_order` maps one onto the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models import doc_ufcn_quant as jdq
from synthesis_in_style_tpu.models.doc_ufcn import get_doc_ufcn as jax_get_doc_ufcn
from synthesis_in_style_tpu_torch.models import doc_ufcn_quant as tdq
from synthesis_in_style_tpu_torch.models.doc_ufcn import get_doc_ufcn
from synthesis_in_style_tpu_torch.ops import quant as tq
from synthesis_in_style_tpu_torch.utils.checkpoint import doc_ufcn_params_from_jax
from test_torch_doc_ufcn import _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FEATURES = (8, 16, 32)
NUM_CLASSES = 3
SIZE = 32


def _models(version, seed=0, **kwargs):
    jmodel = jax_get_doc_ufcn(version)(num_classes=NUM_CLASSES, feature_sizes=FEATURES,
                                       **kwargs)
    variables = jmodel.init({"params": jax.random.PRNGKey(seed),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    variables = _randomize_bn({"params": variables["params"],
                               "batch_stats": variables["batch_stats"]}, seed=seed + 1)
    net = get_doc_ufcn(version)(num_classes=NUM_CLASSES, feature_sizes=FEATURES)
    net.load_state_dict(doc_ufcn_params_from_jax(variables), strict=True)
    return jmodel, variables, net.eval()


def _inputs(seed=2, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)


def _jax_order(name, value, pixel_shuffle):
    """A port per-channel vector (or HWIO weight, channels last) in the JAX
    package's channel order."""
    value = np.asarray(value)
    if pixel_shuffle and name.startswith("decoder_") and name.endswith("/conv"):
        c = value.shape[-1] // 4
        # JAX channel parity * C + ch <- port channel ch * 4 + parity
        order = np.array([ch * 4 + parity for parity in range(4) for ch in range(c)])
        value = value[..., order]
    return value


@pytest.mark.parametrize("version", ["base", "pixelshuffle"])
def test_calibrate_matches_jax_site_by_site(version):
    jmodel, variables, net = _models(version)
    x = _inputs()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        j_amax = jdq.calibrate(jmodel, v64, [x.astype(np.float64), 0.5 * x.astype(np.float64)])
    t_amax = tdq.calibrate(net.double(), [_nchw(x, torch.float64),
                                          0.5 * _nchw(x, torch.float64)])
    net.float()
    assert sorted(t_amax) == sorted(j_amax)
    assert "encoder_0/conv_0" in t_amax and "decoder_0" in t_amax
    for name, ref in j_amax.items():
        got = _jax_order(name, t_amax[name], version == "pixelshuffle")
        assert got.dtype == np.float32 and got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=name)


def _shared_scales(version):
    """The JAX calibration's scales, and the same scales in the port's
    channel order."""
    jmodel, variables, net = _models(version)
    x = _inputs()
    j_amax = jdq.calibrate(jmodel, variables, [x])
    j_scales = jdq.quant_scales_from_amax(j_amax)
    t_scales = {}
    for name, value in j_amax.items():
        value = np.asarray(value)
        if version == "pixelshuffle" and name.startswith("decoder_") and name.endswith("/conv"):
            c = value.shape[0] // 4
            value = value[np.array([parity * c + ch for ch in range(c) for parity in range(4)])]
        t_scales[name] = tdq.quant_scales_from_amax({name: value})[name]
    return jmodel, variables, net, x, j_scales, t_scales


@pytest.mark.parametrize("version", ["base", "pixelshuffle"])
def test_pack_quant_matches_jax(version):
    jmodel, variables, net, _, j_scales, t_scales = _shared_scales(version)
    for name, ref in j_scales.items():
        assert np.max(np.abs(_jax_order(name, t_scales[name].numpy(),
                                        version == "pixelshuffle") - np.asarray(ref))
                      / np.asarray(ref)) <= 1e-7, name
    j_packed = jdq.pack_quant(jmodel, variables, j_scales)
    t_packed = tdq.pack_quant(net, t_scales)
    assert sorted(t_packed) == sorted(j_packed)
    for name, j_site in j_packed.items():
        assert sorted(t_packed[name]) == sorted(j_site), name
        for key, ref in j_site.items():
            got = _jax_order(name, t_packed[name][key].numpy(), version == "pixelshuffle")
            ref = np.asarray(ref)
            assert got.shape == ref.shape, (name, key)
            if key == "w_q":
                assert got.dtype == np.int8
                np.testing.assert_array_equal(got, ref, err_msg=name)
            else:
                np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-7 * np.max(np.abs(ref)),
                                           err_msg=f"{name} {key}")


def _assert_forward_close(t_logits, j_logits):
    j_logits = np.asarray(j_logits)
    assert t_logits.shape == j_logits.shape
    agree = (t_logits.argmax(-1) == j_logits.argmax(-1)).mean()
    assert agree >= 0.999, agree
    assert np.max(np.abs(t_logits - j_logits)) <= 1e-2 * np.max(np.abs(j_logits))


def _int8_outputs(monkeypatch, module, sink, to_numpy):
    original = module.requantize

    def wrapped(y, s_out):
        q = original(y, s_out)
        sink.append(to_numpy(q))
        return q

    monkeypatch.setattr(module, "requantize", wrapped)


@pytest.mark.parametrize("version", ["base", "pixelshuffle"])
def test_quantized_forward_matches_jax(version, monkeypatch):
    jmodel, variables, net, x, j_scales, t_scales = _shared_scales(version)
    j_packed = jdq.pack_quant(jmodel, variables, j_scales)
    t_packed = tdq.pack_quant(net, t_scales)
    j_q, t_q = [], []
    _int8_outputs(monkeypatch, jdq, j_q, np.asarray)
    _int8_outputs(monkeypatch, tdq, t_q, lambda q: q.numpy())
    with jax.disable_jit():
        j_logits = jdq.quantized_forward(jmodel, variables, j_packed, jnp.asarray(x))
    with torch.no_grad():
        t_logits = tdq.quantized_forward(net, t_packed, _nchw(x)).permute(0, 2, 3, 1).numpy()
    monkeypatch.undo()
    _assert_forward_close(t_logits, j_logits)
    assert len(t_q) == len(j_q) > 0
    n_encoder = 5 * len(FEATURES)  # requantizations before the decoder's
    flips = total = 0
    for i, (a, b) in enumerate(zip(t_q, j_q)):
        # a pixel-shuffle decoder conv's 4F channels are in the port's order
        a = _jax_order("decoder_/conv", a, version == "pixelshuffle" and i >= n_encoder)
        assert a.shape == b.shape, i
        assert np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))) <= 1, i
        flips += int(np.sum(a != b))
        total += a.size
    print(f"int8 activation flips: {flips} of {total} ({flips / max(total, 1):.2e})")
    assert total > 0 and flips / total <= 1e-2


def test_quantized_forward_from_an_s2d_checkpoint_and_adapter():
    """The JAX s2d stem and tail keep the parameter tree: an s2d checkpoint
    quantizes as it is in the port (JAX runs its unpacked lowering), and the
    serving adapters of both packages agree."""
    jmodel, variables, net = _models("base", seed=3, s2d_stem=1, s2d_tail=True)
    x = _inputs(seed=4)
    j_net, j_vars = jdq.quantize_for_serving(jmodel, variables, [x])
    t_net = tdq.quantize_for_serving(net, [_nchw(x)])
    assert not t_net.training and t_net.num_classes == NUM_CLASSES
    assert t_net.segmenter_config().num_classes == NUM_CLASSES
    j_logits = j_net.apply(j_vars, jnp.asarray(x), train=False)
    with torch.no_grad():
        t_logits = t_net(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _assert_forward_close(t_logits, j_logits)
    with torch.no_grad():
        float_logits = net(_nchw(x)).permute(0, 2, 3, 1).numpy()
    corr = np.corrcoef(t_logits.ravel(), float_logits.ravel())[0, 1]
    assert corr > 0.995, corr


def test_transpose_up_as_one_by_one_conv_is_exact():
    """ConvTranspose2d(k=2, s=2) == a 1x1 conv to 4F channels in (a, b, f)
    order + depth-to-space, on integer-valued inputs exactly."""
    rng = np.random.default_rng(0)
    conv = torch.nn.ConvTranspose2d(6, 4, 2, stride=2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.integers(-5, 6, (6, 4, 2, 2))).float())
    x = torch.from_numpy(rng.integers(-5, 6, (2, 5, 7, 6))).to(torch.int8)
    w1 = conv.weight.permute(0, 2, 3, 1).reshape(1, 1, 6, 16).to(torch.int8)
    got = tdq._depth_to_space_int8(tq.int8_conv(x, w1), 4)
    ref = conv(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref.detach().numpy().astype(np.int32))


def test_calibration_accumulates_and_restores_mode():
    _, _, net = _models("base", seed=5)
    x = _nchw(_inputs(seed=6))
    net.train()
    a1 = tdq.calibrate(net, [x])
    a2 = tdq.calibrate(net, [x, 2.0 * x])
    assert net.training
    for k in a1:
        assert (a2[k] >= a1[k]).all()
