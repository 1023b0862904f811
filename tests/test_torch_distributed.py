"""Training in more than one process (synthesis_in_style_tpu_torch/parallel/
distributed.py) on the CPU: two real processes on a gloo group against the
single-process step on the same global batch, and against the JAX package.

* One DocUFCN weighted cross-entropy step (no dropout: each process draws its
  own masks): BatchNorm over the global batch, the weighted mean's global
  normalizer, gradients averaged. Every parameter and running statistic of
  both processes equals the single-process step's within 1e-5 of the
  tensor's largest element; a conv bias that feeds train-mode BatchNorm
  (zero at init, true gradient 0) moves by rounding noise only, so it is
  held to 1e-5 of the step's largest update. The loss and the BatchNorm
  running statistics equal the JAX package's global-batch train-mode
  forward within 1e-5 relative.
* One StyleGAN2 iteration (D, R1, G, path length, EMA) at 16 px, global batch
  4 (the minibatch-stddev group of 4 spans both processes; each process
  keeps its rows of the global batch's draws; the path-length mean is the
  global one): every tensor and the reported metrics equal the single-process
  iteration's within 1e-5 relative. (The single-process steps are held
  against the JAX package's in test_torch_gan_steps.py and
  test_torch_segmenter_steps.py.)
* The sharded loader's partition against the JAX loader's, `data_parallel`
  and `local_batch_slice` in one process, and rank-0 gating of the files.

Each group of processes is given at most 120 s; a hang fails its test.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_distributed_worker as worker
from synthesis_in_style_tpu.data.loader import DataLoader as JaxDataLoader
from synthesis_in_style_tpu_torch.core import extensions
from synthesis_in_style_tpu_torch.data.loader import EpochShuffleSampler
from synthesis_in_style_tpu_torch.models.stylegan2 import Discriminator, Generator
from synthesis_in_style_tpu_torch.parallel import distributed
from synthesis_in_style_tpu_torch.utils.checkpoint import doc_ufcn_params_from_jax
from test_torch_doc_ufcn import jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORLD = 2
TIMEOUT = 120
WORKER = Path(__file__).parent / "torch_distributed_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(case, inputs, tmp_path):
    """Run `case` in WORLD processes of one gloo group; their results."""
    torch.save(inputs, tmp_path / "inputs.pt")
    port = str(_free_port())
    procs = []
    for rank in range(WORLD):
        env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK",)}
        env.update(WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), case, str(tmp_path / "inputs.pt"),
             str(tmp_path / f"out{rank}.pt")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log
    results = [torch.load(tmp_path / f"out{rank}.pt") for rank in range(WORLD)]
    assert [r["world_size"] for r in results] == [WORLD] * WORLD
    return results


def _assert_updates_equal(got, ref, before, what, bn_fed_biases=()):
    largest = max(float((ref[k].float() - before[k].float()).abs().max())
                  for k in ref if ref[k].is_floating_point())
    for k, r in ref.items():
        if not r.is_floating_point():
            assert torch.equal(got[k], r), (what, k)
            continue
        scale = largest if k in bn_fed_biases else float(r.abs().max())
        assert float((got[k] - r).abs().max()) <= 1e-5 * scale, (what, k)


def _docufcn_inputs():
    _, variables = jax_variables("no_dropout", seed=4)
    rng = np.random.default_rng(5)
    images = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)  # NHWC, as loaded
    labels = rng.integers(0, 3, (4, 32, 32))
    return variables, {"state": doc_ufcn_params_from_jax(variables),
                       "images": torch.from_numpy(images), "labels": torch.from_numpy(labels),
                       "class_weights": [0.2, 1.0, 2.5]}


def test_docufcn_step_two_processes_equal_one_and_jax(tmp_path):
    variables, inputs = _docufcn_inputs()
    results = _launch("docufcn", inputs, tmp_path)
    single = worker.run_docufcn({**inputs, "state": {k: v.clone() for k, v in
                                                     inputs["state"].items()}})
    assert [r["rows"] for r in results] == [(0, 2), (2, 4)] and single["rows"] == (0, 4)
    bn_fed = {k for k in single["state"] if k.endswith("conv.bias") and "classifier" not in k}
    for r in results:
        _assert_updates_equal(r["state"], single["state"], inputs["state"], "docufcn",
                              bn_fed)
        for k, v in single["metrics"].items():
            assert r["metrics"][k] == pytest.approx(v, rel=1e-5), k

    # the JAX package's global-batch train-mode forward: loss and BatchNorm
    # running statistics
    from synthesis_in_style_tpu.models.doc_ufcn import get_doc_ufcn as jax_get_doc_ufcn

    model = jax_get_doc_ufcn("no_dropout")(num_classes=3, feature_sizes=(8, 16, 32))
    logits, updates = model.apply(
        variables, jnp.asarray(inputs["images"].numpy()), train=True,
        mutable=["batch_stats"])
    log_probs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    labels = jnp.asarray(inputs["labels"].numpy())
    nll = -jnp.take_along_axis(log_probs, labels[..., None], axis=-1)[..., 0]
    w = jnp.asarray(inputs["class_weights"])[labels]
    jax_loss = float(jnp.sum(w * nll) / jnp.sum(w))
    assert results[0]["metrics"]["loss/softmax"] == pytest.approx(jax_loss, rel=1e-5)
    jax_state = doc_ufcn_params_from_jax({"params": variables["params"],
                                          "batch_stats": jax.tree_util.tree_map(
                                              np.asarray, updates["batch_stats"])})
    for k, ref in jax_state.items():
        if "running" in k:
            got = results[1]["state"][k]
            assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), k


def test_gan_iteration_two_processes_equal_one(tmp_path):
    gen = Generator(16, 32, 2, channel_multiplier=1).init_weights(
        torch.Generator().manual_seed(0))
    disc = Discriminator(16, channel_multiplier=1).init_weights(torch.Generator().manual_seed(1))
    real = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (4, 16, 16, 3))
                            .astype(np.float32))
    inputs = {"generator": gen.state_dict(), "discriminator": disc.state_dict(), "real": real}
    results = _launch("gan", inputs, tmp_path)
    single = worker.run_gan({k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                                 else v) for k, v in inputs.items()})
    assert set(single["metrics"]) >= {"train/r1_penalty", "train/path_loss",
                                      "train/mean_path_length", "train/discriminator_loss"}
    for r in results:
        for key in ("generator", "discriminator", "g_ema"):
            before = inputs["generator" if key == "g_ema" else key]
            _assert_updates_equal(r[key], single[key], before, key)
        assert float(r["mean_path_length"]) == pytest.approx(float(single["mean_path_length"]),
                                                             rel=1e-5)
        for k, v in single["metrics"].items():
            assert r["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k


@pytest.mark.parametrize("n,shards", [(10, 3), (8, 2), (5, 4)])
def test_sharded_sampler_matches_the_jax_loader(n, shards):
    for shuffle in (True, False):
        for shard in range(shards):
            jax_loader = JaxDataLoader(list(range(n)), batch_size=1, shuffle=shuffle, seed=7,
                                       shard_id=shard, num_shards=shards)
            sampler = EpochShuffleSampler(n, seed=7, shuffle=shuffle, shard_id=shard,
                                          num_shards=shards)
            for epoch in range(2):
                assert list(sampler) == jax_loader._epoch_indices(epoch).tolist()
            assert len(sampler) == -(-n // shards)
    # the shards of one epoch cover every sample
    seen = sorted(i for s in range(shards)
                  for i in EpochShuffleSampler(n, seed=1, shard_id=s, num_shards=shards))
    assert set(seen) == set(range(n))


def test_single_process_helpers():
    assert not distributed.is_initialized()
    assert distributed.data_parallel(8) is None
    assert distributed.local_batch_slice(8) == slice(0, 8)
    assert (distributed.get_rank(), distributed.get_world_size()) == (0, 1)
    x = torch.arange(6.0).reshape(2, 3)
    assert distributed.all_gather_batch(x) is x and distributed.global_sum(x) is x
    grads = [torch.ones(2), None]
    assert distributed.average_gradients(grads) == grads


def test_only_rank_zero_writes(tmp_path, monkeypatch):
    class Updater:
        iteration, epoch = 3, 0.5

    class Reporter:
        def flush(self):
            return {"loss": 1.0}

    class Trainer:
        updater, reporter = Updater(), Reporter()

    def exercise(log_dir):
        extensions.LogWriter(log_dir, (1, "iteration")).run(Trainer())
        extensions.Snapshotter(lambda t, p: p.parent.mkdir(parents=True) or p.write_text("x"),
                               log_dir, (1, "iteration")).run(Trainer())
        extensions.ImagePlotter(lambda t: np.zeros((4, 4, 3), np.uint8), log_dir,
                                (1, "iteration")).run(Trainer())
        return sorted(str(p.relative_to(log_dir)) for p in log_dir.rglob("*") if p.is_file())

    (tmp_path / "rank0").mkdir()
    assert exercise(tmp_path / "rank0") == ["checkpoints/iter_00000003.pt",
                                            "images/iter_00000003.png", "log.jsonl"]
    monkeypatch.setattr(extensions, "is_main_process", lambda: False)
    (tmp_path / "rank1").mkdir()
    assert exercise(tmp_path / "rank1") == []
