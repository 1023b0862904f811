"""The port's segmenter CLIs with a TransUNet end to end on the CPU (`-d cpu`,
a tiny dataset, the shipped TransUNet config with the `testing` ViT at 256px,
batch 2, 3 iterations, `attention_impl: flash`: the flash op's plain
version). `train` writes log, config and a snapshot with the SGD state;
`--resume-ckpt` continues from it; `analyze_image_segments` loads the
snapshot through the builder and sweeps two pages with the device component
filter. Its `results.json` matches the JAX CLI's, run on the same weights
(converted with `torch_transunet_to_flax` into an orbax snapshot, its config
set to `attention_impl: xla`: the JAX flash kernel runs only on a TPU or in
interpret mode) and pages, within 1e-3 per score; fused page inference (a
page a program, and 2 pages a replay) matches the unfused CLI, and
bfloat16 serving runs the sweep."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from synthesis_in_style_tpu.cli import analyze_image_segments as jax_analyze
from synthesis_in_style_tpu.utils.checkpoint import save_pytree, torch_transunet_to_flax
from synthesis_in_style_tpu_torch.cli import analyze_image_segments as analyze
from synthesis_in_style_tpu_torch.cli import train
from synthesis_in_style_tpu_torch.utils.checkpoint import load_segmenter_snapshot
from test_torch_segmenter_cli import COLORS, _assert_results_match, _page
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SHIPPED = REPO / "configs" / "segmenter" / "stylegan2_trans_u_net_segmenter.yaml"
OVERRIDES = {"pretrained_model_name": "testing", "image_size": 256, "batch_size": 2,
             "max_iter": 3, "snapshot_save_iter": 3, "image_save_iter": 2, "display_size": 2,
             "log_iter": 1, "num_workers": 0, "num_augmentations": 2, "attention_impl": "flash"}
SNAPSHOT = Path("logs") / "run" / "checkpoints" / "iter_00000003.pt"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("transunet_cli")
    rs = np.random.default_rng(0)
    data = root / "data"
    data.mkdir()
    names = []
    for i in range(6):
        img, mask = _page(rs, 64, 64)
        Image.fromarray(np.concatenate([img, mask], axis=1)).save(data / f"p{i}.png")
        names.append(f"p{i}.png")
    (data / "train.json").write_text(json.dumps(names[:4]))
    (data / "val.json").write_text(json.dumps(names[4:]))
    (root / "colors.json").write_text(json.dumps(COLORS))
    config = {**yaml.safe_load(SHIPPED.read_text()), **OVERRIDES}
    (root / "config.json").write_text(json.dumps(config))
    pages, gt = root / "pages", root / "gt"
    pages.mkdir()
    gt.mkdir()
    for i in range(2):
        img, mask = _page(rs, 300, 280)
        Image.fromarray(img).save(pages / f"q{i}.png")
        Image.fromarray(mask).save(gt / f"q{i}_gt.png")
    trainer = _train(root, "run")
    return root, trainer


def _train(root: Path, run: str, *extra):
    args = train.build_parser().parse_args([
        str(root / "config.json"), "--images", str(root / "data" / "train.json"),
        "--val-images", str(root / "data" / "val.json"),
        "--class-to-color-map", str(root / "colors.json"), "-l", str(root / "logs"),
        "-ln", "transunet", "-d", "cpu", "--debug", *extra])
    args.log_dir = str(root / "logs" / run)
    return train.main(args)


def _analyze_argv(root, checkpoint, out, *extra):
    (root / f"{out}.json").write_text(json.dumps(
        {"checkpoint": str(checkpoint), "class_to_color_map": str(root / "colors.json")}))
    return [str(root / "pages"), "-f", str(root / f"{out}.json"), "-gt", str(root / "gt"),
            "-o", str(root / out), "-cds", "-cio", "-cpr", "-cre",
            "--min-confidence", "0.0", "0.7", "--min-contour-area", "0", "5",
            "--use-device-component-filter", *extra]


def test_train_cli_writes_a_run(trained):
    root, trainer = trained
    run = root / "logs" / "run"
    assert trainer.updater.iteration == 3
    assert all(block.attn.impl == "flash"
               for block in trainer.updater.network.transformer.encoder.layer)
    lines = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    for key in ("combined", "CE", "Dice"):
        losses = [line[f"loss/{key}"] for line in lines if f"loss/{key}" in line]
        assert len(losses) == 3 and all(np.isfinite(losses)), key
    assert any("evaluation/dice_weighted_avg" in line for line in lines)
    assert json.loads((run / "config" / "config.json").read_text())["compute_dtype"] == "bfloat16"
    snap = torch.load(root / SNAPSHOT, weights_only=True)
    assert "transformer.encoder.layer.0.attn.query.weight" in snap["segmentation_network"]
    sgd = snap["main_optimizer"]
    assert sgd["param_groups"][0]["update_count"] == 3
    assert sgd["param_groups"][0]["momentum"] == 0.9
    assert all("momentum_buffer" in state for state in sgd["state"].values())


def test_resume_continues_the_run(trained):
    root, _ = trained
    config = json.loads((root / "config.json").read_text())
    (root / "config.json").write_text(json.dumps({**config, "max_iter": 4}))
    try:
        trainer = _train(root, "resumed", "--resume-ckpt", str(root / SNAPSHOT))
    finally:
        (root / "config.json").write_text(json.dumps(config))
    assert trainer.updater.iteration == 4
    assert trainer.updater.optimizer.count == 4  # SGD's updates went on from 3
    assert (root / "logs" / "resumed" / "checkpoints" / "iter_00000004.pt").exists()


def _jax_snapshot(root: Path) -> Path:
    """The trained weights as an orbax snapshot of the JAX package, its
    config's attention through XLA."""
    run = root / "logs" / "run"
    jax_run = root / "jax_run"
    if not jax_run.exists():
        (jax_run / "config").mkdir(parents=True)
        config = json.loads((run / "config" / "config.json").read_text())
        (jax_run / "config" / "config.json").write_text(
            json.dumps({**config, "attention_impl": "xla"}))
        state = load_segmenter_snapshot(root / SNAPSHOT)["segmentation_network"]
        variables = torch_transunet_to_flax({k: v.numpy() for k, v in state.items()})
        save_pytree(jax_run / "checkpoints" / "iter_00000003",
                    {"segmentation_network": variables})
    return jax_run / "checkpoints" / "iter_00000003"


def test_analyze_results_match_the_jax_cli(trained):
    root, _ = trained
    analyze.main(analyze.parse_and_check_arguments(
        _analyze_argv(root, root / SNAPSHOT, "port", "-d", "cpu")))
    jax_analyze.main(jax_analyze.build_parser().parse_args(
        _analyze_argv(root, _jax_snapshot(root), "jax")))
    _assert_results_match(json.loads((root / "port" / "results.json").read_text()),
                          json.loads((root / "jax" / "results.json").read_text()))


def test_fused_pages_match_the_unfused_cli(trained):
    """Fused page inference, one page a program and 2 pages a replay, gives
    the unfused CLI's results.json."""
    root, _ = trained
    port = root / "port" / "results.json"
    if not port.exists():
        analyze.main(analyze.parse_and_check_arguments(
            _analyze_argv(root, root / SNAPSHOT, "port", "-d", "cpu")))
    for out, extra in (("fused", ()), ("fused_batched", ("--pages-per-batch", "2"))):
        analyze.main(analyze.parse_and_check_arguments(
            _analyze_argv(root, root / SNAPSHOT, out, "-d", "cpu", "--fused-page-inference",
                          *extra)))
        _assert_results_match(json.loads((root / out / "results.json").read_text()),
                              json.loads(port.read_text()))


def test_bfloat16_serving_runs(trained):
    root, _ = trained
    analyze.main(analyze.parse_and_check_arguments(_analyze_argv(
        root, root / SNAPSHOT, "bf16", "-d", "cpu", "--serving-dtype", "bfloat16",
        "--fused-page-inference")))
    runs = json.loads((root / "bf16" / "results.json").read_text())["runs"]
    assert len(runs) == 4 and all(len(run["confusion_matrices"]) == 2 for run in runs)
