"""The port's fused whole-page inference against the JAX package's on the
CPU, and against the port's own unfused path: the small DocUFCN of
`test_torch_doc_ufcn.py` (features 8/16/32, weights from JAX `init`
carried across; at seed 4 and min_confidence 0.4 this page holds two
classes, and an area of 12 removes the smaller one's components), patches of
16 in batches of 4, pages of 30-80 px. On the CPU the page program runs
eagerly (a CUDA device would replay a captured graph of the same
function). Confidences agree within 1e-5 (float32 convolutions summed in
another order); class maps on >= 99.9 % of pixels (argmax near-ties may
flip), and exactly where both sides are the port's.

`segment_images` against the JAX package's: a padded chunk, mixed sizes
under bucket_quantum 0, None and 16, output "classes", input order. A
sweep over the thresholds adds no program key."""

import numpy as np
import pytest
from PIL import Image

from synthesis_in_style_tpu.models.base_segmenter import SegmenterConfig as JaxSegmenterConfig
from synthesis_in_style_tpu.segmentation import analysis_segmenter as jax_seg
from synthesis_in_style_tpu_torch.models.base_segmenter import SegmenterConfig
from synthesis_in_style_tpu_torch.segmentation import analysis_segmenter as seg
from test_torch_doc_ufcn import jax_variables, port_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}
CONFIG = {"image_size": 16, "batch_size": 4}
SIZES = ((30, 46), (46, 30), (40, 40), (30, 46), (70, 33))  # (H, W)


@pytest.fixture(scope="module")
def weights():
    model, variables = jax_variables("base", seed=4)
    return model, variables, port_model("base", variables)


def _page(h=30, w=46, seed=11):
    rs = np.random.default_rng(seed)
    page = np.full((h, w, 3), 220, np.uint8) + rs.integers(0, 30, (h, w, 1), dtype=np.uint8)
    for _ in range(h * w // 100):
        y, x = rs.integers(0, h - 3), rs.integers(0, w - 6)
        page[y:y + rs.integers(1, 4), x:x + rs.integers(1, 10)] = rs.integers(0, 90)
    return Image.fromarray(page)


def _jax(weights, assembly, area, fused=True, min_confidence=0.4, **kwargs):
    model, variables, _ = weights
    cls = {"max": jax_seg.AnalysisSegmenter, "vote": jax_seg.VotingAssemblySegmenter}[assembly]
    return cls(None, COLORS, network=model, network_variables=variables, config=dict(CONFIG),
               segmenter_config=JaxSegmenterConfig(3, min_confidence=min_confidence,
                                                   min_contour_area=area),
               fused_page_inference=fused, use_device_component_filter=True,
               print_progress=False, **kwargs)


def _port(weights, assembly, area, fused=True, min_confidence=0.4, **kwargs):
    cls = {"max": seg.AnalysisSegmenter, "vote": seg.VotingAssemblySegmenter}[assembly]
    return cls(None, COLORS, network=weights[2], config=dict(CONFIG),
               segmenter_config=SegmenterConfig(3, min_confidence=min_confidence,
                                                min_contour_area=area),
               fused_page_inference=fused, use_device_component_filter=True, device="cpu",
               **kwargs)


@pytest.mark.parametrize("area", [0, 12])
@pytest.mark.parametrize("overlap", [0, 8])  # 0: the automatic even overlap (None)
@pytest.mark.parametrize("assembly", ["max", "vote"])
def test_fused_matches_jax(weights, assembly, overlap, area):
    ref = _jax(weights, assembly, area, patch_overlap=overlap)
    ours = _port(weights, assembly, area, patch_overlap=overlap)
    page = _page()
    want, got = ref.segment_image(page), ours.segment_image(page)
    assert got.shape == want.shape == (30, 46, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    classes = ours.segment_image_classes(page)
    assert classes.dtype == np.uint8 and classes.shape == (30, 46)
    assert (classes == ref.segment_image_classes(page)).mean() >= 0.999
    assert (classes == got.argmax(-1)).mean() >= 0.999
    if area == 0:  # the page is not one class (area 12 removes the second)
        shares = np.bincount(classes.ravel(), minlength=3) / classes.size
        assert (shares >= 0.01).sum() >= 2, shares


@pytest.mark.parametrize("area", [0, 12])
@pytest.mark.parametrize("overlap", [0, 8])
@pytest.mark.parametrize("assembly", ["max", "vote"])
def test_fused_matches_unfused(weights, assembly, overlap, area):
    """The unfused path with the device filter: the same patches, forward,
    filter and assembly order, so the results agree to float32 rounding."""
    page = _page(40, 40, seed=3)
    fused = _port(weights, assembly, area, patch_overlap=overlap)
    unfused = _port(weights, assembly, area, fused=False, patch_overlap=overlap)
    np.testing.assert_allclose(fused.segment_image(page), unfused.segment_image(page),
                               rtol=0, atol=1e-5)
    assert (fused.segment_image_classes(page) == unfused.segment_image_classes(page)).mean() \
        >= 0.999


def test_area_filter_has_work(weights):
    """On this page the fused area filter removes components (else the
    area cases above would not test it)."""
    page = _page()
    with_filter = _port(weights, "vote", 12).segment_image(page)
    without = _port(weights, "vote", 0).segment_image(page)
    assert np.abs(with_filter - without).max() > 0.1


def _images():
    return [_page(h, w, seed=20 + i) for i, (h, w) in enumerate(SIZES)]


@pytest.mark.parametrize("bucket_quantum", [0, None, 16])
def test_segment_images_matches_jax(weights, bucket_quantum):
    images = _images()
    ref = _jax(weights, "vote", 12).segment_images(images, 3, bucket_quantum=bucket_quantum)
    ours = _port(weights, "vote", 12)
    got = ours.segment_images(images, 3, bucket_quantum=bucket_quantum)
    assert len(got) == len(images)
    for image, mine, theirs in zip(images, got, ref):
        assert mine.shape == theirs.shape == (image.height, image.width, 3)
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-5)
    # input order, and each page as its own tiling gives it
    single = _port(weights, "vote", 12)
    for image, mine in zip(images, got):
        np.testing.assert_allclose(mine, single.segment_image(image), rtol=0, atol=1e-6)
    keys = ours._programs
    assert len(keys) == {0: 4, None: 4, 16: 4}[bucket_quantum]
    assert all(key[-2] == 3 for key in keys)  # 3 pages to a program


def test_segment_images_padded_chunk(weights):
    """5 pages of one size, 2 to a chunk: the last chunk repeats its first
    page, whose result is dropped."""
    images = [_page(30, 46, seed=40 + i) for i in range(5)]
    ref = _jax(weights, "max", 0).segment_images(images, 2)
    got = _port(weights, "max", 0).segment_images(images, 2)
    for mine, theirs in zip(got, ref):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-5)
    assert not np.allclose(got[0], got[1])


@pytest.mark.parametrize("assembly", ["max", "vote"])
def test_segment_images_classes(weights, assembly):
    images = _images()
    ours = _port(weights, assembly, 12)
    classes = ours.segment_images(images, 2, output="classes")
    probs = ours.segment_images(images, 2)
    for image, c, p in zip(images, classes, probs):
        assert c.dtype == np.uint8 and c.shape == (image.height, image.width)
        np.testing.assert_array_equal(c, ours.segment_image_classes(image))
        assert (c == p.argmax(-1)).mean() >= 0.999
    ref = _jax(weights, assembly, 12).segment_images(images, 2, output="classes")
    for c, theirs in zip(classes, ref):
        assert (c == theirs).mean() >= 0.999


def test_sweep_adds_no_program(weights):
    """The thresholds are tensors the programs read: after one page per
    structural setting (area filter off / on), a sweep over both
    thresholds makes no new program, and its values reach the output."""
    page = _page()
    images = _images()[:2]
    ours = _port(weights, "vote", 0)
    first = ours.segment_image(page)
    ours.segment_images(images, 2)
    ours.set_hyperparams({"min_contour_area": 12})
    ours.segment_image(page)
    ours.segment_images(images, 2)
    programs = ours.page_programs()
    # (single page, the two pages' two buckets) x (area filter off, on)
    assert len(programs) == 6
    outputs = []
    for confidence in (0.0, 0.4):
        for area in (0, 1, 12):
            ours.set_hyperparams({"min_confidence": confidence, "min_contour_area": area})
            outputs.append(ours.segment_image(page))
            ours.segment_images(images, 2)
    assert ours.page_programs() == programs
    assert not np.allclose(outputs[0], outputs[3])  # min_confidence reached the program
    assert not np.allclose(outputs[4], outputs[5])  # so did min_contour_area (1 vs 12)
    np.testing.assert_array_equal(outputs[3], first)  # the setting it started from
    # on the CPU the programs run eagerly: nothing was captured or replayed
    assert all(p.replays == 0 and p.cc_labellings_per_replay == 0 for p in programs)


@pytest.mark.parametrize("fused,pages_per_batch", [(False, 3), (True, 1)])
def test_segment_images_falls_back_to_pages(weights, fused, pages_per_batch):
    images = _images()[:3]
    ours = _port(weights, "max", 12, fused=fused)
    got = ours.segment_images(images, pages_per_batch, output="classes")
    for image, mine in zip(images, got):
        np.testing.assert_array_equal(mine, ours.segment_image_classes(image))
    # no multi-page program: unfused makes none, fused only one page a program
    assert all(key[-2] == 1 for key in ours._programs)
    assert bool(ours._programs) == fused


def test_a_replay_counts_the_labellings_its_capture_recorded():
    """A capture records the CC wrapper's calls apart from its launches; a
    replay launches them, so it adds cc_labellings_per_replay to the
    wrapper's count. On the CPU no graph is captured: a stand-in replays."""
    import torch

    from synthesis_in_style_tpu_torch.ops.cuda.segmented_cc import connected_components_cuda

    program = seg.PageProgram(lambda *inputs: None, 1, (16, 16, 3), 4, torch.device("cpu"), None)
    assert program._graph is None and program.cc_labellings_per_replay == 0

    class Replayed:
        calls = 0

        def replay(self):
            Replayed.calls += 1

    program._graph, program.output, program.cc_labellings_per_replay = Replayed(), "out", 3
    before = connected_components_cuda.launches
    zero = torch.zeros(())
    assert program.run(zero, zero) == "out" and program.run(zero, zero) == "out"
    assert Replayed.calls == program.replays == 2
    assert connected_components_cuda.launches - before == 6
