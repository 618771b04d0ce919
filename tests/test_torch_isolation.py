"""The port stands alone: it imports neither JAX nor the JAX package, nor
OpenCV, PIL or imageio, nor the repo's tools/ and configs/ (which import the
JAX package), so it runs on a machine that has none of them."""

import os
import pkgutil
import re
import subprocess
import sys

import self6dpp_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(self6dpp_tpu_torch.__file__)


def port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".c", ".cu", ".cuh"))]
    return files


def test_every_module_imports_without_jax():
    mods = ["self6dpp_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG], "self6dpp_tpu_torch.")]
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'self6dpp_tpu',\n"
        "             'cv2', 'PIL', 'imageio', 'tools', 'configs'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 12, mods


def test_no_source_names_jax_or_the_jax_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|self6dpp_tpu|cv2|PIL"
                     r"|imageio|tools|configs)\b|self6dpp_tpu\.", re.M)
    for path in port_files():
        with open(path) as f:
            text = f.read()
        hits = [m.group(0) for m in bad.finditer(text)]
        assert not hits, (path, hits)
