"""The port's patch-tiled page inference against the JAX package's on the
CPU: a 70x90 page, patches of 32 with an overlap factor of 0.25, a
min_contour_area of 5 under the device component filter (the JAX segmenter
takes its XLA CC path on the CPU, the port its plain CC) and under the host
contour filter, for both the max and the voting assembly. Class maps agree on >= 99.9 % of pixels (argmax
near-ties may flip) and confidences within 1e-4 (float32 convolutions
summed in another order). Also: the closing against the JAX `binary_closing`
(bit-identical), and the patch tiling and overlap rules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from PIL import Image

from synthesis_in_style_tpu.models.base_segmenter import SegmenterConfig as JaxSegmenterConfig
from synthesis_in_style_tpu.segmentation import analysis_segmenter as jax_seg
from synthesis_in_style_tpu.segmentation.device_cc import binary_closing as jax_closing
from synthesis_in_style_tpu_torch.models.base_segmenter import SegmenterConfig
from synthesis_in_style_tpu_torch.segmentation import analysis_segmenter as seg
from synthesis_in_style_tpu_torch.segmentation.device_cc import binary_closing
from test_torch_doc_ufcn import jax_variables, port_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}
CONFIG = {"image_size": 32, "batch_size": 3}


def _page():
    rs = np.random.default_rng(11)
    page = np.full((70, 90, 3), 220, np.uint8) + rs.integers(0, 30, (70, 90, 1), dtype=np.uint8)
    for _ in range(25):
        y, x = rs.integers(0, 66), rs.integers(0, 80)
        page[y:y + rs.integers(1, 5), x:x + rs.integers(1, 12)] = rs.integers(0, 90)
    for _ in range(20):  # specks of 1-2 pixels: below the area of 5
        y, x = rs.integers(0, 69), rs.integers(0, 89)
        page[y, x:x + rs.integers(1, 3)] = rs.integers(0, 90)
    return Image.fromarray(page)


class PixelClassifier(flax_nn.Module):
    """logits = 1x1 conv of the input: a page's dark specks become small
    text components, so the area filter has work on every page."""

    @flax_nn.compact
    def __call__(self, x, train=False):
        return flax_nn.Conv(3, (1, 1), name="classifier")(x)


def _pixel_classifier():
    # (in, out): bright pixels background, dark ones the text classes
    kernel = np.tile(np.array([[4.0, -4.0, -3.5]], np.float32) / 3, (3, 1))
    bias = np.array([0.0, 0.0, -0.3], np.float32)
    variables = {"params": {"classifier": {"kernel": kernel[None, None], "bias": bias}}}
    net = torch.nn.Conv2d(3, 3, 1)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(kernel.T[:, :, None, None]))
        net.bias.copy_(torch.from_numpy(bias))
    return (PixelClassifier(), variables), net


def _segmenters(assembly, min_confidence, min_area, network="docufcn"):
    if network == "docufcn":
        model, variables = jax_variables("base", seed=3)
        port_net = port_model("base", variables)
    else:
        (model, variables), port_net = _pixel_classifier()
    jax_cls = {"max": jax_seg.AnalysisSegmenter, "vote": jax_seg.VotingAssemblySegmenter}[assembly]
    port_cls = {"max": seg.AnalysisSegmenter, "vote": seg.VotingAssemblySegmenter}[assembly]
    common = dict(class_to_color_map=COLORS, config=dict(CONFIG), patch_overlap_factor=0.25,
                  use_device_component_filter=True)
    ref = jax_cls(None, network=model, network_variables=variables,
                  segmenter_config=JaxSegmenterConfig(3, min_confidence=min_confidence,
                                                      min_contour_area=min_area), **common)
    ours = port_cls(None, network=port_net,
                    segmenter_config=SegmenterConfig(3, min_confidence=min_confidence,
                                                     min_contour_area=min_area),
                    device="cpu", **common)
    return ref, ours


@pytest.mark.parametrize("network", ["docufcn", "pixel_classifier"])
@pytest.mark.parametrize("assembly", ["max", "vote"])
def test_page_matches_jax(assembly, network):
    ref, ours = _segmenters(assembly, min_confidence=0.45, min_area=5, network=network)
    page = _page()
    want = ref.segment_image(page)
    got = ours.segment_image(page)
    assert got.shape == want.shape == (70, 90, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    agree = (ours.segment_image_classes(page) == ref.segment_image_classes(page)).mean()
    assert agree >= 0.999, agree
    if network == "pixel_classifier":  # the filter removes components on this page
        ref.set_hyperparams({"min_contour_area": 0})
        assert np.abs(ref.segment_image(page) - want).max() > 0.1


def test_sweep_hyperparams_and_overlap():
    ref, ours = _segmenters("vote", min_confidence=0.0, min_area=0)
    page = _page()
    for config in ({"min_confidence": 0.7, "min_contour_area": 5, "patch_overlap": (5, 0.0)},
                   {"min_confidence": 0.0, "min_contour_area": 0, "patch_overlap": (0, 0.0)}):
        ref.set_hyperparams(config)
        ours.set_hyperparams(config)
        assert ours.patch_overlap == ref.patch_overlap
        np.testing.assert_allclose(ours.segment_image(page), ref.segment_image(page),
                                   rtol=0, atol=1e-4)


def test_area_filter_without_device_filter_raises():
    """Without the device filter an area above 0 no longer raises: it runs
    the host contour filter, as the JAX segmenter does without its device
    filter (polygon areas), and the two pages agree."""
    ref, ours = _segmenters("vote", min_confidence=0.45, min_area=5, network="pixel_classifier")
    ref.use_device_component_filter = ours.use_device_component_filter = False
    page = _page()
    want = ref.segment_image(page)
    np.testing.assert_allclose(ours.segment_image(page), want, rtol=0, atol=1e-4)
    ref.set_hyperparams({"min_contour_area": 0})
    assert np.abs(ref.segment_image(page) - want).max() > 0.1  # the filter removed regions


@pytest.mark.parametrize("kwargs", [dict(quantized=True), dict(mesh=object())])
def test_not_ported_options_raise(kwargs):
    """Mesh serving is not ported yet. `quantized` (ported since; the
    network against the JAX package's: tests/test_torch_quantized_docufcn.py)
    serves a DocUFCN page, calibrated on that page, with class maps that
    agree with the float port's on >= 97 % of pixels (the JAX package's
    gate), the same on the fused route as on the unfused one; any other
    network raises at its first page."""
    if "mesh" in kwargs:
        with pytest.raises(NotImplementedError, match="item 11"):
            seg.AnalysisSegmenter(None, COLORS, config=dict(CONFIG), device="cpu", **kwargs)
        return
    _, ours = _segmenters("vote", min_confidence=0.45, min_area=5)
    float_classes = ours.segment_image_classes(_page())
    ours.quantized, ours._quant_calibrated = True, False
    got = ours.segment_image_classes(_page())
    assert type(ours.network).__name__ == "QuantizedDocUFCN"
    assert (got == float_classes).mean() >= 0.97
    ours.fused_page_inference = True
    np.testing.assert_array_equal(ours.segment_image_classes(_page()), got)
    _, pixel_net = _pixel_classifier()
    other = seg.AnalysisSegmenter(None, COLORS, config=dict(CONFIG), network=pixel_net,
                                  device="cpu", **kwargs)
    with pytest.raises(ValueError, match="DocUFCN"):
        other.segment_image(_page())


@pytest.mark.parametrize("size", [(70, 90), (32, 32), (100, 33), (5, 7)])
@pytest.mark.parametrize("overlap", [None, 8, 31])
def test_patch_bboxes_match_jax(size, overlap):
    h, w = size
    assert seg.calculate_bboxes_for_patches(w, h, 32, overlap) == \
        tuple(tuple(b) for b in jax_seg.calculate_bboxes_for_patches(w, h, 32, overlap))


def test_resolve_patch_overlap_matches_jax():
    for args in ((32, 0, 0.0), (32, 5, 0.0), (32, 0, 0.25), (256, 0, 0.1)):
        assert seg.resolve_patch_overlap(*args) == jax_seg.resolve_patch_overlap(*args)
    with pytest.raises(AssertionError):
        seg.resolve_patch_overlap(32, 4, 0.5)


@pytest.mark.parametrize("density", [0.1, 0.4, 0.7])
def test_binary_closing_bit_identical(density):
    """Edges included: the border is neither foreground nor background."""
    mask = np.random.default_rng(int(density * 10)).random((3, 37, 53)) < density
    mask[0, :, :3] = True
    want = np.asarray(jax_closing(jnp.asarray(mask), 5))
    got = binary_closing(torch.from_numpy(mask), 5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(binary_closing(torch.from_numpy(mask[1]), 3).numpy(),
                                  np.asarray(jax_closing(jnp.asarray(mask[1]), 3)))
