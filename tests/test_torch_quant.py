"""The port's w8a8 quantization (synthesis_in_style_tpu_torch/ops/quant.py and
the quantized generators) against the JAX package's ops/quant.py on the CPU.

Unit functions get identical numpy inputs, so their int8 codes and int32
results must be identical and their scales equal to float32 rounding. The
quantized generators take the same converted weights and latents; their
float activations differ from JAX's by summation order, so a value within
rounding of a .5 boundary can quantize one step apart ("a flip"). The flip
rate of every dynamic activation quantization is measured and bounded, and
the outputs are held to 1e-2 of max|ref| with each layer's correlation
above 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models import stylegan2 as jax_stylegan2
from synthesis_in_style_tpu.models import swagan as jax_swagan
from synthesis_in_style_tpu.ops import quant as jq
from synthesis_in_style_tpu_torch.models import stylegan2, swagan
from synthesis_in_style_tpu_torch.models.factory import get_generator
from synthesis_in_style_tpu_torch.ops import quant as tq
from synthesis_in_style_tpu_torch.ops.cuda import fused_blur
from synthesis_in_style_tpu_torch.segmentation.factor_catalog import FactorCatalog
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    generator_params_from_jax,
    swagan_generator_params_from_jax,
)
from test_torch_stylegan2 import N_MLP, SIZE, STYLE_DIM, _build
from test_torch_swagan import _generators as _swagan_generators
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# a flip is one int8 step at a rounding boundary; measured 3.2e-4 of the codes
# (StyleGAN2, 32 px, perturbed biases) and 2.9e-6 (SWAGAN)
FLIP_RATE_MAX = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (3, 8, 8, 16)])
def test_quantize_per_sample_matches_jax(shape):
    x = (np.random.default_rng(0).normal(size=shape) * 3).astype(np.float32)
    x[0] = 0.0  # the eps floor
    jq_, js = jq.quantize_per_sample(jnp.asarray(x))
    tq_, ts = tq.quantize_per_sample(torch.from_numpy(x))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    assert _rel(ts.numpy(), js) <= 1e-7


def test_quantize_per_out_channel_and_folded_match_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 3, 6, 5)).astype(np.float32)
    w[..., 2] = 0.0
    jw, js = jq.quantize_per_out_channel(jnp.asarray(w))
    tw, ts = tq.quantize_per_out_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert _rel(ts.numpy(), js) <= 1e-7
    for s_in in (rng.uniform(0.01, 0.2, size=6).astype(np.float32), np.float32(0.05)):
        jw, js = jq.quantize_weight_folded(jnp.asarray(w), jnp.asarray(s_in))
        tw, ts = tq.quantize_weight_folded(torch.from_numpy(w), torch.tensor(s_in))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert _rel(ts.numpy(), js) <= 1e-7


def test_requantize_and_scale_from_amax_match_jax():
    rng = np.random.default_rng(2)
    y = (rng.normal(size=(2, 6, 6, 4)) * 4).astype(np.float32)
    y.flat[:8] = [0.5, -0.5, 1.5, 2.5, -2.5, 300.0, -300.0, 0.0]  # ties and clips
    amax = np.abs(y).max(axis=(0, 1, 2))
    amax[1] = 0.0
    js = jq.scale_from_amax(jnp.asarray(amax))
    ts = tq.scale_from_amax(amax)
    assert _rel(ts.numpy(), js) <= 1e-7
    for s_out in (np.ones(4, np.float32), ts.numpy(), np.float32(0.7)):
        np.testing.assert_array_equal(
            tq.requantize(torch.from_numpy(y), torch.tensor(s_out)).numpy(),
            np.asarray(jq.requantize(jnp.asarray(y), jnp.asarray(s_out))))


@pytest.mark.parametrize("kwargs", [
    dict(stride=1, padding=1),
    dict(stride=2, padding=((1, 0), (2, 1))),
    dict(stride=1, padding=0),
    dict(stride=2, padding=1, rhs_dilation=(2, 2)),
    *[dict(stride=1, padding=d, rhs_dilation=(d, d)) for d in (4, 8, 16)],
    dict(stride=1, padding=2, lhs_dilation=(2, 2)),
])
def test_int8_conv_plain_matches_lax(kwargs):
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, size=(2, 19, 17, 8)).astype(np.int8)
    w = rng.integers(-127, 128, size=(3, 3, 8, 5)).astype(np.int8)
    ref = np.asarray(jq.int8_conv(jnp.asarray(x), jnp.asarray(w), **kwargs))
    got = tq.int8_conv(torch.from_numpy(x), torch.from_numpy(w), **kwargs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_int8_conv_one_by_one_and_ragged_channels():
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, size=(3, 6, 5, 24)).astype(np.int8)
    w = rng.integers(-127, 128, size=(1, 1, 24, 12)).astype(np.int8)
    ref = np.asarray(jq.int8_conv(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(tq.int8_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                                  ref)


def test_conv2d_w8a8_and_up2_match_jax_and_the_dilated_route():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 6, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, 5)) * 0.2).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(
        tq.conv2d_w8a8(xt, wt, padding=1).numpy(),
        np.asarray(jq.conv2d_w8a8(jnp.asarray(x), jnp.asarray(w), padding=1)))
    up2 = tq.conv2d_w8a8_up2(xt, wt)
    dilated = tq.conv2d_w8a8(xt, wt, padding=2, lhs_dilation=(2, 2))
    assert up2.shape == (2, 15, 13, 5)
    np.testing.assert_array_equal(up2.numpy(), dilated.numpy())
    np.testing.assert_array_equal(
        up2.numpy(), np.asarray(jq.conv2d_w8a8_up2(jnp.asarray(x), jnp.asarray(w))))


def test_int8_conv_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tq.int8_conv(torch.zeros(1, 3, 3, 4), torch.zeros(3, 3, 4, 4, dtype=torch.int8))


# ---------------------------------------------------------------------------
# quantized generators


def _record_codes(monkeypatch, module, attr, sink, to_numpy):
    original = getattr(module, attr)

    def wrapped(x, *args, **kwargs):
        codes, scale = original(x, *args, **kwargs)
        sink.append(to_numpy(codes))
        return codes, scale

    monkeypatch.setattr(module, attr, wrapped)


def _run_pair(monkeypatch, jgen, variables, tgen, zs):
    """Both quantized generators on the same latents, eagerly, with every
    dynamic activation quantization's codes recorded."""
    j_codes, t_codes = [], []
    _record_codes(monkeypatch, jq, "quantize_per_sample", j_codes, np.asarray)
    _record_codes(monkeypatch, tq, "quantize_per_sample", t_codes, lambda c: c.numpy())
    with jax.disable_jit():
        j_img, j_acts = jgen.apply(variables, [jnp.asarray(z) for z in zs],
                                   randomize_noise=False, return_intermediate_activations=True)
    with torch.no_grad():
        t_img, t_acts = tgen([torch.from_numpy(z) for z in zs], randomize_noise=False,
                             return_intermediate_activations=True)
    monkeypatch.undo()
    return (np.asarray(j_img), {k: np.asarray(v) for k, v in j_acts.items()}, j_codes,
            t_img.numpy(), {k: v.numpy() for k, v in t_acts.items()}, t_codes)


def _check_pair(j_img, j_acts, j_codes, t_img, t_acts, t_codes, n_quantized):
    assert len(j_codes) == len(t_codes) == n_quantized
    flips = sum(int(np.sum(a != b)) for a, b in zip(j_codes, t_codes))
    total = sum(a.size for a in j_codes)
    for a, b in zip(j_codes, t_codes):
        assert np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))) <= 1
    print(f"int8 flips: {flips} of {total} codes ({flips / total:.2e})")
    assert flips / total <= FLIP_RATE_MAX
    assert np.max(np.abs(t_img - j_img)) <= 1e-2 * np.max(np.abs(j_img))
    assert sorted(t_acts) == sorted(j_acts)
    for k in j_acts:
        corr = np.corrcoef(t_acts[k].reshape(-1), j_acts[k].reshape(-1))[0, 1]
        assert corr > 0.999, (k, corr)
        assert np.max(np.abs(t_acts[k] - j_acts[k])) <= 1e-2 * np.max(np.abs(j_acts[k])), k


def test_quantized_stylegan2_matches_jax(monkeypatch):
    jgen, variables, _ = _build(2)
    jq_gen = jax_stylegan2.Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                                     channel_multiplier=2, quantized=True)
    tgen = stylegan2.Generator(SIZE, STYLE_DIM, N_MLP, channel_multiplier=2, quantized=True)
    tgen.load_state_dict(generator_params_from_jax(variables), strict=True)
    zs = [np.random.RandomState(11).randn(2, STYLE_DIM).astype(np.float32)]
    blur_calls = []
    monkeypatch.setattr(stylegan2, "blur_demod_noise_bias_act",
                        lambda *a, **k: blur_calls.append(1))
    result = _run_pair(monkeypatch, jq_gen, variables, tgen.eval(), zs)
    assert not blur_calls  # quantized: the unfused upsample tail
    # conv1 and the non-upsampling StyledConv of each level: 1 + 3 at 32 px
    _check_pair(*result, n_quantized=4)


def test_quantized_swagan_matches_jax(monkeypatch):
    _, variables, _ = _swagan_generators()
    from test_torch_swagan import N_MLP as S_MLP, SIZE as S_SIZE, STYLE_DIM as S_DIM
    jq_gen = jax_swagan.Generator(size=S_SIZE, style_dim=S_DIM, n_mlp=S_MLP, quantized=True)
    tgen = swagan.Generator(S_SIZE, S_DIM, S_MLP, quantized=True)
    tgen.load_state_dict(swagan_generator_params_from_jax(variables), strict=True)
    zs = [np.random.RandomState(12).randn(2, S_DIM).astype(np.float32)]
    result = _run_pair(monkeypatch, jq_gen, variables, tgen.eval(), zs)
    _check_pair(*result, n_quantized=tgen.num_layers // 2 + 1)


def test_quantized_generator_parameters_identical_and_factory_key():
    cfg = {"image_size": 32, "latent_size": 64, "n_mlp": 2, "channel_multiplier": 1}
    float_gen = get_generator(cfg)
    quant_gen = get_generator({**cfg, "quantize": True})
    swagan_gen = get_generator({**cfg, "quantize": True, "stylegan_variant": "swagan"})
    assert not float_gen.quantized and quant_gen.quantized and swagan_gen.quantized
    f_state, q_state = float_gen.state_dict(), quant_gen.state_dict()
    assert list(f_state) == list(q_state)
    assert all(f_state[k].shape == q_state[k].shape for k in f_state)
    quant_gen.load_state_dict(f_state, strict=True)
    convs = [m for m in quant_gen.modules() if isinstance(m, stylegan2.ModulatedConv2d)]
    # int8 exactly where there is no lhs dilation and a demodulated 3x3
    assert [m.quantized for m in convs] == [
        m.kernel_size == 3 and not m.upsample for m in convs]


def test_quantized_cluster_assignment_agrees_with_float():
    """The dataset CLI k-means-assigns the captured activations: fitted on the
    float activations, the quantized generator's per-pixel labels agree on
    more than 0.99 of the pixels (the JAX package's gate), at 64 px."""
    torch.manual_seed(0)
    cfg = {"image_size": 64, "latent_size": 64, "n_mlp": 2, "channel_multiplier": 1}
    gen_f = get_generator(cfg).init_weights(torch.Generator().manual_seed(0)).eval()
    gen_q = get_generator({**cfg, "quantize": True})
    gen_q.load_state_dict(gen_f.state_dict())
    z = torch.from_numpy(np.random.RandomState(7).randn(2, 64).astype(np.float32))
    with torch.no_grad():
        _, acts_f = gen_f([z], randomize_noise=False, return_intermediate_activations=True)
        _, acts_q = gen_q.eval()([z], randomize_noise=False,
                                 return_intermediate_activations=True)
    for layer in (4, 6):
        catalog = FactorCatalog(k=6, seed=0)
        labels_f = catalog.fit_predict(acts_f[layer])
        labels_q = catalog.predict(acts_q[layer])
        agreement = (labels_f == labels_q).double().mean().item()
        assert agreement > 0.99, (layer, agreement)


def test_quantized_upsample_uses_no_fused_blur_kernel(monkeypatch):
    calls = []
    real = fused_blur.blur_demod_noise_bias_act_plain
    monkeypatch.setattr(fused_blur, "blur_demod_noise_bias_act_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = {"image_size": 16, "latent_size": 32, "n_mlp": 1, "channel_multiplier": 1}
    for quantize, expected in ((False, 2), (True, 0)):
        gen = get_generator({**cfg, "quantize": quantize})
        gen.init_weights(torch.Generator().manual_seed(1))
        calls.clear()
        with torch.no_grad():
            gen([torch.zeros(1, 32)], randomize_noise=False)
        assert len(calls) == expected
