"""The port imports neither JAX nor any module of the JAX package, nor
OpenCV: every module of synthesis_in_style_tpu_torch imports in a fresh
interpreter where `import jax` and `import cv2` fail, and leaves no
synthesis_in_style_tpu module loaded."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["cv2"] = None  # the card machine has no OpenCV
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

_IMPORT_LINE = re.compile(r"^\s*(?:import|from)\s+(cv2|jax|synthesis_in_style_tpu)(?:\s|\.|$)")


@pytest.mark.parametrize("module", HOST_ROUTE_MODULES + DISCOVERY_MODULES)
def test_host_route_modules_import_no_cv2_and_no_jax(module):
    """No import line of the module names cv2, jax or the JAX package, and it
    imports where both are blocked."""
    root = Path(__file__).resolve().parents[1]
    source = root / (module.replace(".", "/") + ".py")
    bad = [line for line in source.read_text().splitlines() if _IMPORT_LINE.match(line)]
    assert not bad, bad
    script = ("import sys; sys.modules['jax'] = None; sys.modules['cv2'] = None\n"
              f"import {module}\n"
              "assert not [m for m in sys.modules if m.split('.')[0] == 'synthesis_in_style_tpu']")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_no_cv2_and_no_jax():
    source = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    bad = [line for line in source.read_text().splitlines() if _IMPORT_LINE.match(line)]
    assert not bad, bad
