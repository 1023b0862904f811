"""`scripts/fid_trend.py` of the port against the JAX package's on the CPU:
a run's `checkpoints/` with two `iter_*` snapshots of a 32px generator
(JAX orbax directories, and the same trees as `.npz` for the port), the
same real pages, one embedding and one z stream injected into both
(`tests/torch_evaluation_fixtures.py`). The JSON has the JAX script's
keys, its snapshots in the same order, each within 1e-3 relative of the
JAX value; the port's random-init baseline (its own seeded init, which the
JAX package's PRNG init cannot give) is finite and present. The JAX run
skips its baseline: it compiles a generator init."""

import json

import pytest

from synthesis_in_style_tpu.scripts import fid_trend as jax_trend
from synthesis_in_style_tpu_torch.scripts import fid_trend as port_trend

from tests.torch_evaluation_fixtures import (
    generator_tree,
    same_features,
    same_z,
    write_checkpoint,
    write_pages,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_fid_trend_matches_jax(tmp_path, monkeypatch):
    for i, name in enumerate(("iter_00000004", "iter_00000008")):
        jax_snap, port_snap = write_checkpoint(tmp_path, name, generator_tree(20 + i))
        # one run directory per package, both snapshots in it
        for snap in (jax_snap, port_snap):
            run = snap.parent.parent.parent / "run"
            (run / "checkpoints").mkdir(parents=True, exist_ok=True)
            if not (run / "config").exists():
                snap.parent.parent.joinpath("config").rename(run / "config")
            snap.rename(run / "checkpoints" / snap.name)
    write_pages(tmp_path / "pages", 6)
    same_features(monkeypatch)
    same_z(monkeypatch)
    common = ["--images", str(tmp_path / "pages"), "--num-samples", "8", "--batch", "4"]
    assert jax_trend.main([str(tmp_path / "jax" / "run" / "checkpoints"), *common, "--skip-init",
                           "--json", str(tmp_path / "jax.json")]) == 0
    report = {}
    assert port_trend.main([str(tmp_path / "port" / "run" / "checkpoints"), *common, "-d", "cpu",
                            "--json", str(tmp_path / "port.json")], report) == 0
    ours = json.loads((tmp_path / "port.json").read_text())
    theirs = json.loads((tmp_path / "jax.json").read_text())
    assert list(ours) == list(theirs)
    assert {k: ours[k] for k in ("image_size", "num_samples", "embedding")} == \
        {k: theirs[k] for k in ("image_size", "num_samples", "embedding")}
    assert list(ours["checkpoints"]) == ["init"] + list(theirs["checkpoints"]) == \
        ["init", "iter_00000004", "iter_00000008"]
    for name, want in theirs["checkpoints"].items():
        assert ours["checkpoints"][name] == pytest.approx(want, rel=1e-3), name
    assert 0 < ours["checkpoints"]["init"] < float("inf")
    assert list(report["seconds"]) == list(ours["checkpoints"])
