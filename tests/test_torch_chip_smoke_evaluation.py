"""chip_smoke.py's evaluation phase rehearsed on the CPU (its docstring
describes the rehearsal), and the script's phase table.

The rehearsal runs `evaluation_phase` with DEVICE = "cpu" at 32px (a
seeded generator of latent 32, n_mlp 2, channel multiplier 1; its w+
autoencoder from `write_autoencoder_snapshot`), the phase's counts shrunk
(EVAL_VAL_PAGES 4, EVAL_BATCH 2, EVAL_FID_SAMPLES 4, EVAL_TREND (4, 2),
EVAL_CHECK_IMAGES 1, EVAL_CHECK_FID 4, EVAL_RATE_PASSES 1), a seeded sweep results.json, a
coco_gt.json of seeded pairs, and stand-in launch counters that wrappers of
the plain bias-act forward and blur tail increment: the launch counts the
phase predicts must be the ones that ran. Then `--only`'s dependency rule,
and the exit without a CUDA device."""

import importlib.util
import json
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from synthesis_in_style_tpu_torch.evaluation import fid
from synthesis_in_style_tpu_torch.evaluation.coco_gt import create_coco_gt_from_image_root
from synthesis_in_style_tpu_torch.models.factory import get_generator
from synthesis_in_style_tpu_torch.ops import fused_act
from synthesis_in_style_tpu_torch.ops.cuda import fused_blur
from synthesis_in_style_tpu_torch.scripts import evaluate_checkpoints
from synthesis_in_style_tpu_torch.utils.png import write_png

from tests.torch_results_fixtures import make_results
from tests.torch_threads import one_torch_thread  # noqa: F401

CONFIG = {"image_size": 32, "latent_size": 32, "n_mlp": 2, "channel_multiplier": 1,
          "stylegan_variant": 2}
NAMES = ("fused_bias_act", "fused_bias_act_bwd", "fused_blur", "segmented_cc",
         "flash_attention_fwd", "flash_attention_bwd")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_evaluation", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gan_run(root: Path, seed: int, iterations=(4, 8)) -> Path:
    """A run directory with `iter_N.pt` GAN snapshots ({"g_ema": state
    dict}) beside config/config.json; returns its checkpoints/."""
    (root / "config").mkdir(parents=True)
    (root / "config" / "config.json").write_text(json.dumps(CONFIG))
    (root / "checkpoints").mkdir()
    for i, n in enumerate(iterations):
        gen = get_generator(CONFIG).init_weights(torch.Generator().manual_seed(seed + i))
        torch.save({"g_ema": gen.state_dict()}, root / "checkpoints" / f"iter_{n:08d}.pt")
    return root / "checkpoints"


def _pages(directory: Path, n: int) -> Path:
    directory.mkdir()
    rs = np.random.RandomState(0)
    names = []
    for i in range(n):
        page = np.full((32, 32, 3), 230, np.uint8)
        page[rs.randint(0, 28):, rs.randint(0, 20):][:3, :10] = 20
        write_png(directory / f"page_{i}.png", page)
        names.append(f"page_{i}.png")
    (directory / "train.json").write_text(json.dumps(names))
    return directory


def _pairs(directory: Path) -> Path:
    directory.mkdir()
    rs = np.random.RandomState(1)
    for i in range(3):
        label = np.zeros((32, 32, 3), np.uint8)
        label[4 + i:10 + i, 3:12] = (0, 0, 255)
        label[18:24, 14 + i:26] = (255, 0, 0)
        write_png(directory / f"pair_{i}.png", np.concatenate(
            [rs.randint(0, 256, (32, 32, 3)).astype(np.uint8), label], axis=1))
    colours = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                          "handwriting_colors.json").read_text())
    return create_coco_gt_from_image_root(directory, colours)


def _stand_in_counters(monkeypatch) -> dict:
    fns = {name: SimpleNamespace(launches=0, shapes=Counter()) for name in NAMES}
    bias_act, blur = fused_act.fused_leaky_relu_plain, fused_blur.blur_demod_noise_bias_act_plain

    def counted(name, fn):
        def run(x, *args, **kwargs):
            fns[name].launches += 1
            fns[name].shapes[(tuple(x.shape), x.dtype)] += 1
            return fn(x, *args, **kwargs)
        return run

    monkeypatch.setattr(fused_act, "fused_leaky_relu_plain", counted("fused_bias_act", bias_act))
    monkeypatch.setattr(fused_blur, "blur_demod_noise_bias_act_plain",
                        counted("fused_blur", blur))
    return fns


def test_evaluation_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    smoke = _chip_smoke()
    for name, value in (("DEVICE", "cpu"), ("EVAL_VAL_PAGES", 4), ("EVAL_BATCH", 2),
                        ("EVAL_FID_SAMPLES", 4), ("EVAL_TREND", (4, 2)),
                        ("EVAL_CHECK_IMAGES", 1), ("EVAL_CHECK_FID", 4), ("EVAL_RATE_PASSES", 1),
                        ("CONFIG_256", {**smoke.CONFIG_256, **CONFIG})):
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "set_tf32", lambda enabled: None)
    monkeypatch.setattr(smoke, "_defaults", lambda: None)
    # no loader workers: forking a process that runs JAX's threads can hang
    make_loader = evaluate_checkpoints.make_loader
    monkeypatch.setattr(evaluate_checkpoints, "make_loader", lambda *a, **k: make_loader(
        *a, **{**k, "num_workers": 0}))
    # one seeded VGG16 for every FID object (each would draw the same one)
    embeddings, default = {}, fid.default_feature_fn

    def shared_embedding(state_dict=None, device="cuda", seed=0):
        key = (str(device), seed)
        if state_dict is not None:
            return default(state_dict, device, seed)
        if key not in embeddings:
            embeddings[key] = default(None, device, seed)
        return embeddings[key]

    monkeypatch.setattr(fid, "default_feature_fn", shared_embedding)
    gan = _gan_run(tmp_path / "gan_run", 0, (8,)) / "iter_00000008.pt"
    trend = _gan_run(tmp_path / "trend_run", 5)
    pages = _pages(tmp_path / "pages", 6)
    ae = smoke.write_autoencoder_snapshot(tmp_path, gan, CONFIG)
    results = tmp_path / "results.json"
    results.write_text(json.dumps(make_results()))
    coco = _pairs(tmp_path / "pairs")
    fns = _stand_in_counters(monkeypatch)

    out = smoke.evaluation_phase(tmp_path, gan, pages, ae, trend, pages / "train.json", results,
                                 coco, fns)
    checkpoints = out["evaluate_checkpoints"]
    # two FIDs of 4 samples at -b 2 (2 x 2 forwards from z: 2 mapping + 4
    # synthesis bias-acts and 3 blur tails each) and 2 w+ decodes of the 4
    # val pages (4 and 3)
    assert {k: checkpoints["launches"][k] for k in ("fused_bias_act", "fused_blur")} == \
        {"fused_bias_act": 4 * 6 + 2 * 4, "fused_blur": 4 * 3 + 2 * 3}
    assert set(checkpoints["results"]) == {"iter_00000008_reconstruction", "iter_00000008_fid",
                                           "ae_reconstruction", "ae_fid"}
    assert "skipped" in checkpoints["results"]["iter_00000008_reconstruction"]
    assert checkpoints["reconstructed_images"] == 4
    assert all(v > 0 for v in checkpoints["split"].values())
    # fid_trend: init and both snapshots, 2 forwards each
    assert list(out["fid_trend"]["trend"]["checkpoints"]) == ["init", "iter_00000004",
                                                              "iter_00000008"]
    assert out["fid_trend"]["launches"]["fused_bias_act"] == 3 * 2 * 6
    assert out["results_tools"]["launches"] == dict.fromkeys(NAMES, 0)
    assert len(out["results_tools"]["figures"]) == 16
    assert out["coco_dataset"]["images"] == 3 and out["coco_dataset"]["annotations"] >= 6
    assert out["gates"]["reconstruction"]["psnr_abs_diff"] == 0.0
    assert out["reconstruction_rate"]["images"] == 4 and out["reconstruction_rate"]["seconds"] > 0
    assert set(out["seconds"]) == {"gates", "reconstruction_rate", "evaluate_checkpoints",
                                   "fid_trend", "results_tools", "path_kernels"}


def test_only_runs_a_phase_with_what_it_needs():
    smoke = _chip_smoke()
    names = [p.name for p in smoke.PHASES]
    assert names[-1] == "evaluation" and len(set(names)) == len(names)
    for phase in smoke.PHASES:  # a phase needs only phases that run before it
        assert all(names.index(n) < names.index(phase.name) for n in phase.needs), phase.name
    assert [p.name for p in smoke.resolve_phases(["evaluation"])] == [
        "discovery", "dataset", "training", "segmenter", "capstone", "autoencoder", "evaluation"]
    assert [p.name for p in smoke.resolve_phases(["serving", "kernels"])] == [
        "kernels", "discovery", "dataset", "segmenter", "serving"]
    assert smoke.resolve_phases(None) == list(smoke.PHASES)
    with pytest.raises(AssertionError, match="fused_blur was not launched on the x path"):
        smoke.check_paths("p", {"x": (dict.fromkeys(NAMES, 1) | {"fused_blur": 0},
                                      ("fused_bias_act", "fused_blur"))})


def test_without_a_card_the_script_exits_before_any_phase(capsys):
    smoke = _chip_smoke()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert smoke.main([]) == 2
    assert smoke.main(["--only", "evaluation"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
