"""One process of the port's multi-process CPU runs (tests/test_torch_distributed.py).

    python tests/torch_distributed_worker.py <case> <inputs.pt> <out.pt>

The launcher's environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT)
comes from the test; `maybe_initialize_distributed` opens a gloo group from
it. With no such environment the same code is the single-process run on the
global batch. `case` is "docufcn" (one weighted cross-entropy step) or "gan"
(one StyleGAN2 iteration: D, R1, G, path length, EMA). The result (state
dicts, reported metrics, the rows this process read) goes to `out.pt`.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from synthesis_in_style_tpu_torch.models.doc_ufcn import get_doc_ufcn  # noqa: E402
from synthesis_in_style_tpu_torch.models.stylegan2 import Discriminator, Generator  # noqa: E402
from synthesis_in_style_tpu_torch.parallel import distributed  # noqa: E402
from synthesis_in_style_tpu_torch.updaters.segmentation_updater import (  # noqa: E402
    SegmentationUpdater,
)
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import (  # noqa: E402
    GANOptimizer,
    StyleGAN2Config,
    StyleGAN2Updater,
    create_gan_train_state,
)

# Adam with eps 1: an update proportional to its gradient where the gradient
# is small, so that float32 rounding of a near-zero gradient (a conv bias
# before train-mode BatchNorm) does not become a +-lr sign flip
EPS = 1.0


def _capture(updater):
    reported = {}
    updater.report = lambda values, prefix="": reported.update(
        {f"{prefix}/{k}": float(v) for k, v in values.items()})
    return reported


def run_docufcn(inputs):
    net = get_doc_ufcn("no_dropout")(num_classes=3, feature_sizes=(8, 16, 32))
    net.load_state_dict(inputs["state"])
    optimizer = GANOptimizer(net.parameters(), lambda _: 1e-3, (0.9, 0.999), eps=EPS,
                             weight_decay=1e-4)
    rows = distributed.local_batch_slice(inputs["images"].shape[0])
    batch = {"images": inputs["images"][rows], "segmented": inputs["labels"][rows]}
    updater = SegmentationUpdater(net, optimizer, {"images": iter([batch])},
                                  class_weights=inputs["class_weights"], device="cpu")
    reported = _capture(updater)
    updater.update()
    return {"state": net.state_dict(), "metrics": reported, "rows": (rows.start, rows.stop)}


def run_gan(inputs):
    gen = Generator(16, 32, 2, channel_multiplier=1)
    disc = Discriminator(16, channel_multiplier=1)
    gen.load_state_dict(inputs["generator"])
    disc.load_state_dict(inputs["discriminator"])
    state = create_gan_train_state(gen, disc, lambda _: 2e-3, lambda _: 2e-3, (0.0, 0.99),
                                   (0.0, 0.99))
    state.g_optimizer = GANOptimizer(gen.parameters(), lambda _: 2e-3, (0.0, 0.99), eps=EPS)
    state.d_optimizer = GANOptimizer(disc.parameters(), lambda _: 2e-3, (0.0, 0.99), eps=EPS)
    state.mean_path_length.fill_(0.5)
    real = inputs["real"]
    rows = distributed.local_batch_slice(real.shape[0])
    cfg = StyleGAN2Config(d_reg_every=1, g_reg_every=1, mixing_prob=0.5)
    updater = StyleGAN2Updater(state, {"images": iter([real[rows]])},
                               batch_size=real.shape[0], cfg=cfg, seed=3, device="cpu")
    reported = _capture(updater)
    updater.update()
    return {"generator": gen.state_dict(), "discriminator": disc.state_dict(),
            "g_ema": state.g_ema.state_dict(), "mean_path_length": state.mean_path_length,
            "metrics": reported, "rows": (rows.start, rows.stop)}


def main(case: str, inputs_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    distributed.maybe_initialize_distributed(device="cpu")
    inputs = torch.load(inputs_path)
    result = {"docufcn": run_docufcn, "gan": run_gan}[case](inputs)
    result["world_size"] = distributed.get_world_size()
    torch.save(result, out_path)
    if distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
