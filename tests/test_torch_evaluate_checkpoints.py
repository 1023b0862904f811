"""`scripts/evaluate_checkpoints.py` of the port against the JAX package's
on the CPU: both `main`s on the same checkpoints (a 32px generator and a
32px w+ autoencoder; JAX orbax directories, and the same trees as `.npz`
for the port) and the same datasets JSON, at `-b 1` (the JAX evaluator
asserts a batch of one, so only `-b 1` yields numbers there).

The JAX FID runs on the autoencoder snapshot's g_ema (it jits its
sampler anew for each checkpoint), the generator snapshot's FID on the
port alone (tests/test_torch_fid_trend.py holds snapshots' FID against the
JAX package). Tolerances: reconstruction PSNR within 1e-4 dB and SSIM within 1e-5 (the
w+ encoder predicts every noise map, so the reconstruction draws none and
the two packages see the same decode); FID within 1e-3 relative, with one
embedding and one z stream injected into both (`tests/
torch_evaluation_fixtures.py`); a generator's `skipped` reconstruction
JSON equal. Then the port alone: `-b 4` gives `-b 1`'s reconstruction
(per image at any batch), a second run loads nothing, and a bad
combination lands in the FAILED list without stopping the sweep. A JAX
autoencoder `.npz` without a `g_ema` tree records its FID as skipped; one
whose `g_ema` tree does not load lands in the FAILED list."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from synthesis_in_style_tpu.scripts import evaluate_checkpoints as jax_eval
from synthesis_in_style_tpu_torch.scripts import evaluate_checkpoints as port_eval

from tests.torch_evaluation_fixtures import (
    autoencoder_tree,
    generator_tree,
    same_features,
    same_z,
    write_checkpoint,
    write_pages,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

FID_SAMPLES = 8


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    gen_jax, gen_port = write_checkpoint(root, "gan_snapshot", generator_tree(11))
    ae_jax, ae_port = write_checkpoint(root, "ae_snapshot", autoencoder_tree(12))
    write_pages(root / "pages", 3)
    datasets = root / "datasets.json"
    datasets.write_text(json.dumps([{"name": "val", "images": str(root / "pages" / "val.json")}]))
    lists = {}
    for kind, paths in (("jax", (gen_jax, ae_jax)), ("port", (gen_port, ae_port))):
        lists[kind] = root / f"{kind}_checkpoints.txt"
        lists[kind].write_text("\n".join(str(p) for p in paths) + "\n")
    lists["jax_generator"] = root / "jax_generator.txt"
    lists["jax_generator"].write_text(f"{gen_jax}\n")
    lists["jax_autoencoder"] = root / "jax_autoencoder.txt"
    lists["jax_autoencoder"].write_text(f"{ae_jax}\n")
    return root, lists, datasets


@pytest.fixture(autouse=True)
def no_loader_workers(monkeypatch):
    """The port's loader without worker processes: forking a process that
    runs JAX's threads can deadlock the child."""
    make_loader = port_eval.make_loader
    monkeypatch.setattr(port_eval, "make_loader",
                        lambda *args, **kwargs: make_loader(*args, **{**kwargs,
                                                                    "num_workers": 0}))


def _args(module, checkpoints, datasets, out, *extra):
    argv = [str(checkpoints), str(datasets), "--evaluation-root", str(out), "-b", "1",
            "--num-fid-samples", str(FID_SAMPLES), *extra]
    if module is port_eval:
        argv += ["-d", "cpu"]
    return module.build_parser().parse_args(argv)


def _read(root, name, kind):
    return json.loads((root / "val" / f"{name}_{kind}.json").read_text())


def test_main_matches_jax(inputs, monkeypatch):
    root, lists, datasets = inputs
    same_features(monkeypatch)
    same_z(monkeypatch)
    # the JAX package jits its sampler anew for each checkpoint (~12 s on
    # this generator): its FID runs on the autoencoder's g_ema only
    jax_eval.main(_args(jax_eval, lists["jax_generator"], datasets, root / "jax_eval",
                        "--skip-fid"))
    jax_eval.main(_args(jax_eval, lists["jax_autoencoder"], datasets, root / "jax_eval"))
    report = {}
    assert port_eval.main(_args(port_eval, lists["port"], datasets, root / "port_eval"),
                          report) == []
    assert len(report["seconds"]) == 2
    ours, theirs = root / "port_eval", root / "jax_eval"
    assert _read(ours, "gan_snapshot", "reconstruction") == \
        _read(theirs, "gan_snapshot", "reconstruction") == {
            "skipped": "generator-only checkpoint has no reconstruction path"}
    got, want = _read(ours, "ae_snapshot", "reconstruction"), _read(
        theirs, "ae_snapshot", "reconstruction")
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5, (got, want)
    got, want = _read(ours, "ae_snapshot", "fid")["fid"], _read(theirs, "ae_snapshot",
                                                              "fid")["fid"]
    assert got == pytest.approx(want, rel=1e-3) and got > 0, (got, want)
    # the generator's FID: finite, another generator than the autoencoder's
    gan_fid = _read(ours, "gan_snapshot", "fid")["fid"]
    assert 0 < gan_fid < float("inf") and gan_fid != got


def test_port_batch_resume_and_failures(inputs, monkeypatch, capsys):
    root, lists, datasets = inputs
    one, four = root / "b1", root / "b4"
    port_eval.main(_args(port_eval, lists["port"], datasets, one, "--skip-fid"))
    args = _args(port_eval, lists["port"], datasets, four, "--skip-fid")
    args.batch_size = 4
    port_eval.main(args)
    got, want = _read(four, "ae_snapshot", "reconstruction"), _read(one, "ae_snapshot",
                                                                    "reconstruction")
    assert abs(got["psnr"] - want["psnr"]) <= 1e-5 and abs(got["ssim"] - want["ssim"]) <= 1e-6
    assert not (one / "val" / "ae_snapshot_fid.json").exists()

    # resume: everything evaluated is skipped before anything is loaded
    def refuse(*args, **kwargs):
        raise AssertionError("loaded a checkpoint that was evaluated already")

    with monkeypatch.context() as m:
        for name in ("load_autoencoder_or_generator", "load_generator",
                     "load_config_from_checkpoint"):
            m.setattr(port_eval, name, refuse)
        assert port_eval.main(_args(port_eval, lists["port"], datasets, one,
                                    "--skip-fid")) == []

    # one bad combination: reported, and the sweep goes on
    bad = root / "bad_checkpoints.txt"
    bad.write_text(f"{root / 'missing.npz'}\n" + lists["port"].read_text())
    failed = port_eval.main(_args(port_eval, bad, datasets, root / "with_bad", "--skip-fid"))
    assert [(c, n) for c, n, _ in failed] == [(str(root / "missing.npz"), "val")]
    assert "FAILED" in capsys.readouterr().out
    assert _read(root / "with_bad", "ae_snapshot", "reconstruction") == want


def test_fid_skips_only_a_checkpoint_without_g_ema(inputs, tmp_path):
    root, lists, _ = inputs
    ae = Path(lists["port"].read_text().split()[1])
    with np.load(ae) as data:
        arrays = dict(data)
    keep = {"ae_only": lambda k: not k.startswith(("g_ema/", "g_noises/")),
            "broken_g_ema": lambda k: not (k.startswith("g_ema/") and "to_rgb" in k)}
    paths = {}
    for name, kept in keep.items():
        path = tmp_path / f"{name}_run" / "checkpoints" / f"{name}.npz"
        path.parent.mkdir(parents=True)
        shutil.copytree(ae.parent.parent / "config", path.parent.parent / "config")
        np.savez(path, **{k: v for k, v in arrays.items() if kept(k)})
        paths[name] = path
    listing = tmp_path / "checkpoints.txt"
    listing.write_text(f"{paths['ae_only']}\n{paths['broken_g_ema']}\n")
    pages = json.loads((root / "pages" / "val.json").read_text())
    (root / "pages" / "val_one.json").write_text(json.dumps(pages[:1]))
    one_page = tmp_path / "datasets.json"
    one_page.write_text(json.dumps([{"name": "val",
                                     "images": str(root / "pages" / "val_one.json")}]))
    out = tmp_path / "eval"
    failed = port_eval.main(_args(port_eval, listing, one_page, out))
    assert [(c, n) for c, n, _ in failed] == [(str(paths["broken_g_ema"]), "val")]
    assert _read(out, "ae_only", "fid") == {"skipped": "the checkpoint holds no g_ema generator"}
    assert set(_read(out, "ae_only", "reconstruction")) == {"psnr", "ssim"}
    assert set(_read(out, "broken_g_ema", "reconstruction")) == {"psnr", "ssim"}
    assert not (out / "val" / "broken_g_ema_fid.json").exists()
