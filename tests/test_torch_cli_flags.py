"""The port's command lines against the JAX package's (CPU):

* every option string a JAX CLI's parser accepts, the port's counterpart
  accepts too (the torch-era `-d/--device`, `--local_rank`, `--mpi-backend`
  included);
* a reference single-process launch line runs the single-process path:
  `--local_rank 0 --mpi-backend nccl` trains in `train_stylegan_2` (with
  one warning for the backend), passes `train`'s and the adversarial CLI's
  checks (`--local_rank 0` is silent in all three, as in the JAX package),
  and `-d cuda` on the adversarial CLI reaches its device check;
* more than one process is the launch (parallel/distributed.py): an
  announced launch passes the CLIs' checks silently and `compat.launch`
  opens its process group; a positive `--local_rank` without the
  launcher's environment raises."""

import argparse
import importlib
import json
import warnings

import pytest

from synthesis_in_style_tpu_torch.cli import compat
from synthesis_in_style_tpu_torch.cli import train as port_train
from synthesis_in_style_tpu_torch.cli import train_adversarial_generator as port_adv
from synthesis_in_style_tpu_torch.cli import train_stylegan_2 as port_gan

from tests.torch_threads import one_torch_thread  # noqa: F401

PAIRED = ("cli.analyze_image_segments", "cli.create_dataset_for_activation_classification",
          "cli.create_dataset_for_segmentation", "cli.create_semantic_segmentation",
          "cli.train", "cli.train_adversarial_generator", "cli.train_stylegan_2",
          "cli.evaluate_metrics", "cli.extract_results_subset", "cli.plot_metrics",
          "scripts.analyze_latent_code", "scripts.auto_label_clusters",
          "scripts.select_cluster_config", "scripts.make_capstone_fixture",
          "scripts.run_capstone_chain", "scripts.evaluate_checkpoints", "scripts.fid_trend")


class _Captured(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _parser(module, monkeypatch) -> argparse.ArgumentParser:
    """The module's parser: `build_parser()`, or the one its `main(argv)`
    builds (caught at parse_args)."""
    if hasattr(module, "build_parser"):
        return module.build_parser()

    def capture(self, *args, **kwargs):
        raise _Captured(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Captured) as caught:
            module.main([])
    return caught.value.parser


@pytest.mark.parametrize("name", PAIRED)
def test_port_accepts_every_option_of_the_jax_cli(name, monkeypatch):
    theirs = _parser(importlib.import_module(f"synthesis_in_style_tpu.{name}"), monkeypatch)
    ours = _parser(importlib.import_module(f"synthesis_in_style_tpu_torch.{name}"), monkeypatch)
    missing = set(theirs._option_string_actions) - set(ours._option_string_actions)
    assert not missing, (name, sorted(missing))
    positional = [a.dest for a in theirs._actions if not a.option_strings]
    assert positional == [a.dest for a in ours._actions if not a.option_strings], name


@pytest.mark.parametrize("config", [{}, {"local_rank": 0}, {"local_rank": None}])
def test_single_process_launch_is_silent_in_both_training_clis(config, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_train.check_supported(config)
        port_gan.check_supported(config)
    with pytest.warns(UserWarning, match="--mpi-backend nccl"):
        port_train.check_supported({**config, "mpi_backend": "nccl"})
    with pytest.warns(UserWarning, match="--mpi-backend gloo"):
        port_gan.check_supported({**config, "mpi_backend": "gloo"})


@pytest.mark.parametrize("check", [port_train.check_supported, port_gan.check_supported,
                                   compat.launch])
def test_more_than_one_process_raises_naming_item_11(check, monkeypatch):
    """More than one process (ROADMAP item 11, once unported) is now the
    launch. The CLIs' checks pass an announced launch without a warning for
    its backend; `compat.launch` raises for a positive --local_rank that no
    launcher announced, and opens the process group of an announced one (a
    gloo group of one process here) and returns the process's device."""
    import torch.distributed as dist

    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    if check is compat.launch:
        with pytest.raises(RuntimeError, match="torchrun"):
            check({"local_rank": 1, "mpi_backend": "gloo", "device": "cpu"})
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    if check is not compat.launch:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            check({"local_rank": 0, "mpi_backend": "nccl"})
        return
    try:
        assert str(check({"local_rank": 0, "mpi_backend": "gloo", "device": "cpu"})) == "cpu"
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_reference_launch_line_trains_the_gan(tmp_path, monkeypatch):
    from tests.test_torch_gan_training import _run_cli, _write_run_inputs

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    data = _write_run_inputs(tmp_path, n_images=2)
    config = json.loads((data / "config.json").read_text())
    (data / "config.json").write_text(json.dumps({**config, "compute_dtype": None}))
    with pytest.warns(UserWarning, match="--mpi-backend nccl"):
        trainer = _run_cli(data, tmp_path / "logs", "--local_rank", "0", "--mpi-backend", "nccl")
    assert trainer.updater.iteration == 2


def test_adversarial_cli_takes_a_reference_launch_line(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(port_adv.torch.cuda, "is_available", lambda: False)
    line = ["c.yaml", "ae.pt", "-o", "real.json", "-f", "fake.json", "-d", "cuda",
            "--local_rank", "0", "--mpi-backend", "nccl"]
    args = port_adv.build_parser().parse_args(line)
    assert (args.device, args.local_rank, args.mpi_backend) == ("cuda", 0, "nccl")
    # past the flag checks, into the single-process run: its device check
    monkeypatch.setattr(port_adv, "load_config_from_checkpoint", lambda *a: {"seed": 0})
    with pytest.warns(UserWarning, match="--mpi-backend nccl"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_adv.main(args)
    # a positive rank that no launcher announced: the launch refuses it
    with pytest.raises(RuntimeError, match="torchrun"):
        port_adv.main(port_adv.build_parser().parse_args(
            line[:-5] + ["cpu", "--local_rank", "1"]))
    assert port_adv.build_parser().parse_args(line[:6]).device == "cuda"
