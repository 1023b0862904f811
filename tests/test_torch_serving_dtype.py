"""bfloat16 serving (`serving_dtype="bfloat16"`) against the JAX package's on
the CPU: the small DocUFCN of `test_torch_doc_ufcn.py` (seed 4, whose class
map on this page holds two classes), patches of 16, on the fused and the
unfused path. Both cast the network once and run the forward in bfloat16,
the softmax in float32; they round at other places, so the gate is the
JAX package's own: argmax agreement >= 0.99
(tests/test_quantized_docufcn.py). Also: every floating parameter and
BatchNorm buffer is bfloat16, and `quantized` beside a serving dtype raises
ValueError.

On the full-width DocUFCN that `chip_smoke.py` seeds for its multi-class
checks (32/64/128/256, 256-px patches, a 512x512 crop of its first page,
0.0 / 0), bfloat16 moves the logits by ~14 % in the port and ~15 % in the
JAX package, and neither side's class map agrees with its float32 one on
0.99 of the pixels (0.943 and 0.938 here): that gate cannot hold such a
network. Both agree on >= 0.99 of the pixels whose float32 logit margin
is 4 or more (about 0.6 of them), the gate the card holds."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.models.base_segmenter import SegmenterConfig as JaxSegmenterConfig
from synthesis_in_style_tpu.segmentation import analysis_segmenter as jax_seg
from synthesis_in_style_tpu_torch.models.base_segmenter import SegmenterConfig
from synthesis_in_style_tpu_torch.segmentation import analysis_segmenter as seg
from test_torch_doc_ufcn import jax_variables, port_model
from test_torch_fused_pages import COLORS, CONFIG, _page
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def weights():
    model, variables = jax_variables("base", seed=4)
    return model, variables


def _pair(weights, assembly, fused, serving_dtype="bfloat16"):
    model, variables = weights
    jax_cls = {"max": jax_seg.AnalysisSegmenter, "vote": jax_seg.VotingAssemblySegmenter}[assembly]
    port_cls = {"max": seg.AnalysisSegmenter, "vote": seg.VotingAssemblySegmenter}[assembly]
    ref = jax_cls(None, COLORS, network=model, network_variables=variables, config=dict(CONFIG),
                  segmenter_config=JaxSegmenterConfig(3), fused_page_inference=fused,
                  serving_dtype=serving_dtype, print_progress=False)
    ours = port_cls(None, COLORS, network=port_model("base", variables), config=dict(CONFIG),
                    segmenter_config=SegmenterConfig(3), fused_page_inference=fused,
                    serving_dtype=serving_dtype, device="cpu")
    return ref, ours


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("assembly", ["max", "vote"])
def test_bfloat16_serving_matches_jax(weights, assembly, fused):
    ref, ours = _pair(weights, assembly, fused)
    page = _page(40, 40, seed=5)
    want, got = ref.segment_image(page), ours.segment_image(page)
    assert got.dtype == np.float32 and got.shape == want.shape == (40, 40, 3)
    assert np.isfinite(got).all()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.99, agree
    shares = np.bincount(got.argmax(-1).ravel(), minlength=3) / got[..., 0].size
    assert (shares >= 0.01).sum() >= 2, shares
    # and against the port's own float32 serving
    _, f32 = _pair(weights, assembly, fused, serving_dtype=None)
    assert (f32.segment_image(page).argmax(-1) == got.argmax(-1)).mean() >= 0.99
    assert (ours.segment_image_classes(page) == got.argmax(-1)).mean() >= 0.999


def test_every_parameter_and_statistic_is_bfloat16(weights):
    _, ours = _pair(weights, "vote", True)
    assert ours.serving_dtype == torch.bfloat16
    assert {p.dtype for p in ours.network.parameters()} == {torch.bfloat16}
    norms = [m for m in ours.network.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert norms
    for m in norms:
        assert m.running_mean.dtype == m.running_var.dtype == m.weight.dtype == torch.bfloat16
        assert m.num_batches_tracked.dtype == torch.int64
    for name in ("float32", "f32", None):
        assert _pair(weights, "vote", False, serving_dtype=name)[1].serving_dtype is None


def test_serving_dtype_with_quantized_raises():
    with pytest.raises(ValueError, match="mutually exclusive"):
        seg.AnalysisSegmenter(None, COLORS, config=dict(CONFIG), device="cpu",
                              network=torch.nn.Conv2d(3, 3, 1), quantized=True,
                              serving_dtype="bfloat16")


@pytest.mark.parametrize("serving_dtype", ["int8", "float16"])
def test_other_serving_dtypes_raise(serving_dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        seg.AnalysisSegmenter(None, COLORS, config=dict(CONFIG), device="cpu",
                              network=torch.nn.Conv2d(3, 3, 1), serving_dtype=serving_dtype)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bfloat16_on_the_seeded_full_width_network_as_in_jax():
    from PIL import Image

    from synthesis_in_style_tpu.models.doc_ufcn import get_doc_ufcn as jax_get_doc_ufcn
    from synthesis_in_style_tpu.utils.checkpoint import torch_doc_ufcn_to_flax

    smoke = _chip_smoke()
    page, _ = smoke.draw_page(np.random.default_rng(smoke.SEED + 7))  # the card's page 0
    net = smoke.seeded_page_network(Image.fromarray(page))
    variables = torch_doc_ufcn_to_flax({k: v.numpy() for k, v in net.state_dict().items()})
    model = jax_get_doc_ufcn("base")(num_classes=3)
    crop = Image.fromarray(page[256:768, 256:768])
    config = {"image_size": 256, "batch_size": 4}
    out = {}
    for dtype in (None, "bfloat16"):
        ref = jax_seg.VotingAssemblySegmenter(
            None, COLORS, network=model, network_variables=variables, config=dict(config),
            segmenter_config=JaxSegmenterConfig(3, min_confidence=0.0),
            fused_page_inference=True, serving_dtype=dtype, print_progress=False)
        ours = seg.VotingAssemblySegmenter(
            None, COLORS, network=smoke.copy.deepcopy(net), config=dict(config),
            segmenter_config=SegmenterConfig(3, min_confidence=0.0), fused_page_inference=True,
            serving_dtype=dtype, device="cpu")
        out["jax", dtype], out["port", dtype] = ref.segment_image(crop), ours.segment_image(crop)
    # float32: the same network on both sides, with more than one class
    assert (out["port", None].argmax(-1) == out["jax", None].argmax(-1)).mean() >= 0.999
    shares = np.bincount(out["port", None].argmax(-1).ravel(), minlength=3) / crop.size[0] ** 2
    assert (shares >= 0.05).sum() == 3, shares
    agree = {side: float((out[side, None].argmax(-1) == out[side, "bfloat16"].argmax(-1)).mean())
             for side in ("jax", "port")}
    assert agree["jax"] < 0.99, agree  # the JAX package's own bfloat16 misses its gate here
    assert abs(agree["port"] - agree["jax"]) <= 0.02, agree
    for side in ("jax", "port"):
        share, confident = smoke.confident_agreement(out[side, None], out[side, "bfloat16"])
        assert share >= 0.25 and confident >= 0.99, (side, share, confident)
