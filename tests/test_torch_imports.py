"""The port imports neither JAX nor any module of the JAX package, nor
OpenCV: every module of synthesis_in_style_tpu_torch imports in a fresh
interpreter where `import jax` and `import cv2` fail, and leaves no
synthesis_in_style_tpu module loaded."""

import subprocess
import sys
from pathlib import Path

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
