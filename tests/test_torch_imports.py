"""Import hygiene of the PyTorch port: no module of redmax_tpu_torch, and
not chip_smoke.py or scripts/f32_card.py (both run on the card), imports
JAX, jaxlib, optax or the JAX package."""

import ast
import glob
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "redmax_tpu")
FILES = sorted(glob.glob(os.path.join(ROOT, "redmax_tpu_torch", "**", "*.py"), recursive=True)) + [
    os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scripts", "f32_card.py")
]


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_scan_covers_the_package():
    names = {os.path.basename(p) for p in FILES}
    assert {"chord_kernel.py", "integrators.py", "mpc.py", "chip_smoke.py", "qp_kernel.py",
            "qp.py", "constraints.py", "scenes_matlab.py", "kernel_build.py", "forces.py"} <= names
