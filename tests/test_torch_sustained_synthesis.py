"""The port's sustained-synthesis script against the JAX package's: the same
helpers, the same record keys and `--` pass-through, and one real run of
the port's dataset CLI under it at 32 px on the CPU."""

import json
import os
import sys
import types

from synthesis_in_style_tpu.scripts import sustained_synthesis as jax_script
from synthesis_in_style_tpu_torch.scripts import sustained_synthesis as port_script
from test_torch_dataset_segmentation import _cli_run


def _fake_run(module, monkeypatch, tmp_path, argv):
    """The script's main with a stand-in CLI process that writes one PNG per
    poll: returns (the command it launched, its JSONL records)."""
    image_dir = tmp_path.parent / "run" / "generated_images" / "0" / "0"
    image_dir.mkdir(parents=True, exist_ok=True)
    tmp_path.mkdir(parents=True, exist_ok=True)
    launched = []

    class FakeProc:
        def __init__(self, cmd):
            launched.append(cmd)
            self.pid, self.returncode, self._polls = os.getpid(), None, 0

        def poll(self):
            self._polls += 1
            (image_dir / f"{tmp_path.name}{self._polls}.png").write_bytes(b"")
            if self._polls > 3:
                self.returncode = 0
            return self.returncode

    monkeypatch.setattr(module.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        time=iter(range(100)).__next__, sleep=lambda s: None))
    out = tmp_path / f"{module.__name__.split('.')[0]}.jsonl"
    assert module.main(["--monitor-out", str(out)] + argv) == 0
    return launched[0], [json.loads(line) for line in out.read_text().splitlines()]


def test_records_and_pass_through_match_jax(tmp_path, monkeypatch):
    ckpt = tmp_path / "run" / "checkpoints" / "g.npz"
    argv = [str(ckpt), "c.json", "-n", "7", "--interval", "1", "--", "-b", "4", "-d", "cpu"]
    j_cmd, j_rows = _fake_run(jax_script, monkeypatch, tmp_path / "j", argv)
    p_cmd, p_rows = _fake_run(port_script, monkeypatch, tmp_path / "p", argv)
    assert j_cmd[:3] == [sys.executable, "-m", "synthesis_in_style_tpu.cli."
                         "create_dataset_for_segmentation"]
    assert p_cmd[:3] == [sys.executable, "-m", port_script.CLI_MODULE]
    assert p_cmd[3:] == j_cmd[3:] == [str(ckpt), "c.json", "-n", "7", "-b", "4", "-d", "cpu"]
    assert len(p_rows) == len(j_rows) == 3
    assert [sorted(r) for r in p_rows] == [sorted(r) for r in j_rows]
    for p_row, j_row in zip(p_rows, j_rows):
        assert {k: p_row[k] for k in ("t", "pairs_written", "window_pairs_per_s")} == \
            {k: j_row[k] for k in ("t", "pairs_written", "window_pairs_per_s")}
        assert p_row["fds"] > 0 and p_row["rss_mb"] > 0


def test_helpers_match_jax(tmp_path):
    for rel in ("0/0/a.png", "0/0/b.png", "0/1/c.png", "0/d.png", "0/0/e.json"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    assert port_script.count_outputs(tmp_path) == jax_script.count_outputs(tmp_path) == 4
    assert port_script.count_outputs(tmp_path / "absent") == 0
    rss, fds = port_script.proc_stats(os.getpid())
    assert rss > 0 and fds > 0
    assert port_script.proc_stats(2**22 + 12345) == (None, None)


def test_real_run_of_the_port_cli(tmp_path):
    run_dir, argv = _cli_run(tmp_path)
    monitor = tmp_path / "m.jsonl"
    code = port_script.main([argv[0], argv[1], "-n", "4", "--interval", "0.5",
                             "--monitor-out", str(monitor), "--", *argv[2:]])
    assert code == 0
    rows = [json.loads(line) for line in monitor.read_text().splitlines()]
    assert rows and all(set(r) == {"t", "pairs_written", "window_pairs_per_s", "rss_mb", "fds"}
                        for r in rows)
    assert port_script.count_outputs(run_dir / "generated_images") >= 4
