"""The port imports neither JAX nor any module of the JAX package, nor
OpenCV, matplotlib or pandas: every module of synthesis_in_style_tpu_torch
imports in a fresh interpreter where `import jax`, `import cv2`, `import
matplotlib` and `import pandas` fail, and leaves no synthesis_in_style_tpu
module loaded."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["cv2"] = None  # the card machine has no OpenCV
sys.modules["matplotlib"] = None  # nor matplotlib
sys.modules["pandas"] = None  # nor pandas
import synthesis_in_style_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m == "synthesis_in_style_tpu" or m.startswith("synthesis_in_style_tpu.")
)
assert not leaked, leaked
assert "triton" not in sys.modules
print(len(names))
"""


def test_port_imports_no_jax_and_no_jax_package():
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=root, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was reached


# the host contour route's modules: the tracer, its users, the worker pool
HOST_ROUTE_MODULES = (
    "synthesis_in_style_tpu_torch.utils.contour_ops",
    "synthesis_in_style_tpu_torch.segmentation.contours",
    "synthesis_in_style_tpu_torch.segmentation.contour_pool",
    "synthesis_in_style_tpu_torch.segmentation.dataset_segmenter",
    "synthesis_in_style_tpu_torch.segmentation.factor_catalog",
    "synthesis_in_style_tpu_torch.evaluation.coco_gt",
    "synthesis_in_style_tpu_torch.models.base_segmenter",
    "synthesis_in_style_tpu_torch.cli.analyze_image_segments",
    "synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation",
)

# the cluster-discovery path's modules
DISCOVERY_MODULES = (
    "synthesis_in_style_tpu_torch.segmentation.kmeans",
    "synthesis_in_style_tpu_torch.segmentation.ptutils",
    "synthesis_in_style_tpu_torch.cli.create_semantic_segmentation",
    "synthesis_in_style_tpu_torch.scripts.select_cluster_config",
    "synthesis_in_style_tpu_torch.scripts.auto_label_clusters",
)

# the capstone recipe's training legs: resume, warm start, FID, fixture, chain
CAPSTONE_MODULES = (
    "synthesis_in_style_tpu_torch.utils.checkpoint",
    "synthesis_in_style_tpu_torch.utils.profiling",
    "synthesis_in_style_tpu_torch.data.json_dataset",
    "synthesis_in_style_tpu_torch.losses.feature_extractors",
    "synthesis_in_style_tpu_torch.models.inception_v3",
    "synthesis_in_style_tpu_torch.evaluation.fid",
    "synthesis_in_style_tpu_torch.cli.train_stylegan_2",
    "synthesis_in_style_tpu_torch.cli.train",
    "synthesis_in_style_tpu_torch.scripts.make_capstone_fixture",
    "synthesis_in_style_tpu_torch.scripts.run_capstone_chain",
)

# the SWAGAN and EMANet modules
SWAGAN_EMANET_MODULES = (
    "synthesis_in_style_tpu_torch.models.swagan",
    "synthesis_in_style_tpu_torch.models.ema_net",
    "synthesis_in_style_tpu_torch.models.factory",
    "synthesis_in_style_tpu_torch.ops.resize",
    "synthesis_in_style_tpu_torch.ops.upfirdn2d",
    "synthesis_in_style_tpu_torch.training_builder.ema_net_builder",
    "synthesis_in_style_tpu_torch.updaters.segmentation_updater",
    "synthesis_in_style_tpu_torch.updaters.stylegan2_updater",
)

# the autoencoder and GAN-inversion branch's modules, and StyleGAN1
AUTOENCODER_MODULES = (
    "synthesis_in_style_tpu_torch.models.encoder",
    "synthesis_in_style_tpu_torch.models.autoencoder",
    "synthesis_in_style_tpu_torch.models.stylegan1",
    "synthesis_in_style_tpu_torch.losses.lpips",
    "synthesis_in_style_tpu_torch.losses.lpips_rank",
    "synthesis_in_style_tpu_torch.losses.perceptual",
    "synthesis_in_style_tpu_torch.updaters.autoencoder_updater",
    "synthesis_in_style_tpu_torch.updaters.adversarial_updater",
    "synthesis_in_style_tpu_torch.data.autoencoder_dataset",
    "synthesis_in_style_tpu_torch.cli.train_adversarial_generator",
    "synthesis_in_style_tpu_torch.latent_projecting",
    "synthesis_in_style_tpu_torch.scripts.analyze_latent_code",
    "synthesis_in_style_tpu_torch.utils.plots",
)

# the DatasetGAN branch's modules
DATASET_GAN_MODULES = (
    "synthesis_in_style_tpu_torch.models.pixel_classifier",
    "synthesis_in_style_tpu_torch.evaluation.dataset_gan_evaluator",
    "synthesis_in_style_tpu_torch.segmentation.dataset_gan_segmenter",
    "synthesis_in_style_tpu_torch.data.dataset_gan_dataset",
    "synthesis_in_style_tpu_torch.updaters.dataset_gan_updater",
    "synthesis_in_style_tpu_torch.training_builder.pixel_ensemble_builder",
    "synthesis_in_style_tpu_torch.visualization.dataset_gan_plotter",
    "synthesis_in_style_tpu_torch.cli.create_dataset_for_activation_classification",
)

# the evaluation family: PSNR / SSIM, checkpoint evaluation, the FID
# trend, the results tools, the COCO dataset and the torch-era flags
EVALUATION_MODULES = (
    "synthesis_in_style_tpu_torch.evaluation.psnr_ssim",
    "synthesis_in_style_tpu_torch.evaluation.results_analysis",
    "synthesis_in_style_tpu_torch.scripts.evaluate_checkpoints",
    "synthesis_in_style_tpu_torch.scripts.fid_trend",
    "synthesis_in_style_tpu_torch.cli.evaluate_metrics",
    "synthesis_in_style_tpu_torch.cli.extract_results_subset",
    "synthesis_in_style_tpu_torch.cli.plot_metrics",
    "synthesis_in_style_tpu_torch.cli.compat",
    "synthesis_in_style_tpu_torch.data.coco_dataset",
)

# the int8 serving paths, DocUFCN remat, the sustained-synthesis run and
# training in more than one process
OPTIONS_MODULES = (
    "synthesis_in_style_tpu_torch.ops.quant",
    "synthesis_in_style_tpu_torch.ops.cuda.int8_conv",
    "synthesis_in_style_tpu_torch.models.doc_ufcn_quant",
    "synthesis_in_style_tpu_torch.models.doc_ufcn",
    "synthesis_in_style_tpu_torch.segmentation.analysis_segmenter",
    "synthesis_in_style_tpu_torch.scripts.sustained_synthesis",
    "synthesis_in_style_tpu_torch.parallel",
    "synthesis_in_style_tpu_torch.parallel.distributed",
    "synthesis_in_style_tpu_torch.data.loader",
    "synthesis_in_style_tpu_torch.core.extensions",
    "synthesis_in_style_tpu_torch.losses.segmentation",
)

_IMPORT_LINE = re.compile(
    r"^\s*(?:import|from)\s+(cv2|jax|matplotlib|pandas|synthesis_in_style_tpu)(?:\s|\.|$)")


@pytest.mark.parametrize("module", HOST_ROUTE_MODULES + DISCOVERY_MODULES + CAPSTONE_MODULES
                         + SWAGAN_EMANET_MODULES + DATASET_GAN_MODULES
                         + AUTOENCODER_MODULES + EVALUATION_MODULES + OPTIONS_MODULES)
def test_host_route_modules_import_no_cv2_and_no_jax(module):
    """No import line of the module names cv2, jax, matplotlib, pandas or
    the JAX package, and it imports where they are blocked."""
    root = Path(__file__).resolve().parents[1]
    source = root / (module.replace(".", "/") + ".py")
    if not source.exists():  # a package
        source = source.with_suffix("") / "__init__.py"
    bad = [line for line in source.read_text().splitlines() if _IMPORT_LINE.match(line)]
    assert not bad, bad
    script = ("import sys; sys.modules['jax'] = None; sys.modules['cv2'] = None\n"
              "sys.modules['matplotlib'] = None; sys.modules['pandas'] = None\n"
              f"import {module}\n"
              "assert not [m for m in sys.modules if m.split('.')[0] == 'synthesis_in_style_tpu']")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_no_cv2_and_no_jax():
    source = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    bad = [line for line in source.read_text().splitlines() if _IMPORT_LINE.match(line)]
    assert not bad, bad
