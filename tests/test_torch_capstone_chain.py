"""The port's capstone chain (`scripts/run_capstone_chain.py`) with its five
legs stubbed: each leg is a small script that records its command line and
writes what the real CLI would leave behind. Held here: every leg runs the
port's module (never the JAX package's) with `-d` passed through, in the JAX
chain's order and with its arguments; the GAN config is read from the YAML
beside the snapshot (`load_config_from_checkpoint`, not a hard-coded
config.json); the segmenter snapshot evaluated is the newest `iter_*.pt` of
the newest run (never a `.tmp`); `chain_report.json` has the JAX chain's
keys; a failing leg ends the chain with its return code recorded. The real
legs run on the card in chip_smoke.py's capstone phase."""

import json
import sys
from pathlib import Path

import pytest

from synthesis_in_style_tpu_torch.scripts import run_capstone_chain as chain

REPO = Path(__file__).resolve().parents[1]

STUB = r'''
import json, os, sys
from pathlib import Path
args = sys.argv[1:]
assert args[0] == "-m"
module, rest = args[1], args[2:]
with open(os.environ["CHAIN_STUB_LOG"], "a") as f:
    f.write(json.dumps([module] + rest) + "\n")
name = module.rsplit(".", 1)[1]
if name == os.environ.get("CHAIN_STUB_FAIL"):
    sys.exit(3)
def value(flag):
    return rest[rest.index(flag) + 1]
if name == "train":
    run = Path(value("-l")) / value("-ln")
    for stamp, iters in (("2026-01-01T00:00:00", (5,)), ("2026-01-02T00:00:00", (8, 16))):
        ckpts = run / stamp / "checkpoints"
        ckpts.mkdir(parents=True)
        for it in iters:
            (ckpts / f"iter_{it:08d}.pt").write_bytes(b"x")
    (run / "2026-01-02T00:00:00" / "checkpoints" / "iter_00000099.pt.tmp").write_bytes(b"x")
if name == "analyze_image_segments":
    out = Path(value("-o"))
    out.mkdir(parents=True)
    def scores(w):
        return {k: {"score": v} for k, v in
                (("background", 0.9), ("printed_text", w), ("handwritten_text", w / 2),
                 ("weighted_avg", w))}
    runs = [{"average_dice_scores": scores(w)} for w in (0.2, 0.6, 0.4)]
    (out / "results.json").write_text(json.dumps({"runs": runs}))
'''


@pytest.fixture()
def stubbed(tmp_path, monkeypatch):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    log = tmp_path / "legs.jsonl"
    monkeypatch.setenv("CHAIN_STUB_LOG", str(log))
    gan_run = tmp_path / "gan" / "2026-01-01T00:00:00"
    (gan_run / "checkpoints").mkdir(parents=True)
    (gan_run / "config").mkdir()
    (gan_run / "config" / "config.yaml").write_text("image_size: 128\nlatent_size: 512\n")
    snapshot = gan_run / "checkpoints" / "iter_00000040.pt"
    snapshot.write_bytes(b"x")
    fixture = tmp_path / "fixture"
    argv = [str(snapshot), str(tmp_path / "work"), "--fixture", str(fixture),
            "--ks", "4", "6", "--num-discovery-samples", "16", "--num-pairs", "64",
            "--epochs", "1", "--batch-size", "8", "--min-confidence", "0.0", "0.7",
            "--min-contour-area", "0", "55", "--use-device-component-filter",
            "--select-args", "--dark-fraction 0.75 --num-cd-layers 3",
            "--seg-config", str(REPO / "configs/segmenter/stylegan2_doc_ufcn_segmenter.yaml"),
            "-d", "cpu"]
    return tmp_path, [sys.executable, str(stub)], argv, log, snapshot, fixture


def test_chain_runs_the_ports_legs_in_order(stubbed):
    tmp_path, interpreter, argv, log, snapshot, fixture = stubbed
    assert chain.main(argv, interpreter=interpreter) == 0
    legs = [json.loads(line) for line in log.read_text().splitlines()]
    modules = [leg[0] for leg in legs]
    assert modules == [f"synthesis_in_style_tpu_torch.{m}" for m in (
        "cli.create_semantic_segmentation", "scripts.select_cluster_config",
        "cli.create_dataset_for_segmentation", "cli.train", "cli.analyze_image_segments")]
    work = tmp_path / "work"
    for leg in legs:
        assert leg[leg.index("-d") + 1] == "cpu", leg
    discovery, select, synthesis, training, sweep = (leg[1:] for leg in legs)
    assert discovery[:2] == [str(snapshot), "--destination"]
    assert discovery[discovery.index("-n") + 1] == "16"
    assert discovery[discovery.index("-c") + 1:discovery.index("-c") + 3] == ["4", "7"]
    assert select[select.index("--ks") + 1:select.index("--ks") + 3] == ["4", "6"]
    assert select[select.index("--out-tag") + 1] == "sel"
    assert select[-4:] == ["--dark-fraction", "0.75", "--num-cd-layers", "3"]
    assert synthesis[1] == str(work / "sem" / "creation_config_sel.json")
    assert synthesis[synthesis.index("--num-clusters") + 1] == "sel"
    assert synthesis[synthesis.index("-n") + 1] == "64"
    assert "--device-contours" not in synthesis  # the host route, as the JAX chain

    seg_config = json.loads((work / "seg_config.json").read_text())
    assert seg_config["image_size"] == 128  # from the YAML beside the GAN snapshot
    assert seg_config["epochs"] == 1 and seg_config["batch_size"] == 8
    assert seg_config["class_weights"] == [1.0, 4.0, 10.0]
    assert seg_config["network"] == "DocUFCN" and seg_config["num_augmentations"] == 2
    assert training[0] == str(work / "seg_config.json")
    assert Path(training[training.index("-l") + 1]).is_absolute()

    eval_config = json.loads((work / "eval_config.json").read_text())
    assert eval_config["checkpoint"].endswith(
        "2026-01-02T00:00:00/checkpoints/iter_00000016.pt")
    assert sweep[0] == str(fixture / "eval" / "images")
    assert sweep[sweep.index("--min-contour-area") + 1:][:2] == ["0", "55"]
    assert "--use-device-component-filter" in sweep

    report = json.loads((work / "chain_report.json").read_text())
    assert list(report["legs"]) == ["cluster_discovery", "select_config", "labelled_synthesis",
                                    "segmenter_training", "sweep_eval"]
    for leg in report["legs"].values():
        assert leg["returncode"] == 0 and leg["seconds"] > 0
    assert report["total_seconds"] >= sum(leg["seconds"] for leg in report["legs"].values())
    assert report["best_dice"] == {"background": 0.9, "printed_text": 0.6,
                                   "handwritten_text": 0.3, "weighted_avg": 0.6}
    assert report["num_pairs"] == 64 and report["checkpoint"] == str(snapshot)


def test_a_failing_leg_ends_the_chain(stubbed, monkeypatch):
    tmp_path, interpreter, argv, log, _, _ = stubbed
    monkeypatch.setenv("CHAIN_STUB_FAIL", "create_dataset_for_segmentation")
    with pytest.raises(SystemExit, match="labelled_synthesis failed"):
        chain.main(argv, interpreter=interpreter)
    assert len(log.read_text().splitlines()) == 3
    assert not (tmp_path / "work" / "chain_report.json").exists()


def test_skip_discovery_and_defaults(stubbed):
    tmp_path, interpreter, argv, log, _, _ = stubbed
    argv = [a for a in argv if a != "--use-device-component-filter"] + ["--skip-discovery"]
    assert chain.main(argv, interpreter=interpreter) == 0
    legs = [json.loads(line) for line in log.read_text().splitlines()]
    assert legs[0][0].endswith("select_cluster_config") and len(legs) == 4
    assert "--use-device-component-filter" not in legs[-1]
    assert chain.build_parser().parse_args(["c", "w", "--fixture", "f"]).device == "cuda"
