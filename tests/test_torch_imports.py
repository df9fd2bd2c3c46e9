"""The port imports torch, never JAX, the JAX package, the tests or Triton.

Every .py file of birefnet_tpu_torch/ (parallel/ included: its spawned
ranks import the port alone), chip_smoke.py and the tools that
run on the GPU machine (gpu_profile.py, k3_phases.py, core_time.py,
tf32_check.py, tap_conv_phases.py, deform_im2col_time.py,
deform_col2im_time.py and serve_stages.py; that machine has no JAX) is parsed
with `ast`; an import of `jax`, `birefnet_tpu` (not `birefnet_tpu_torch`),
`tests` or `triton` fails, wherever it stands: at the top of a module,
inside a function (a lazy import in a launcher counts), or as a constant
string given to `importlib.import_module` or `__import__`. The kernels are
CUDA C++ built with nvcc; nothing needs Triton.
"""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "birefnet_tpu_torch", "**", "*.py"),
                       recursive=True)
) + ["chip_smoke.py", os.path.join("tools", "gpu_profile.py"),
     os.path.join("tools", "k3_phases.py"),
     os.path.join("tools", "core_time.py"),
     os.path.join("tools", "tf32_check.py"),
     os.path.join("tools", "tap_conv_phases.py"),
     os.path.join("tools", "deform_im2col_time.py"),
     os.path.join("tools", "deform_col2im_time.py"),
     os.path.join("tools", "serve_stages.py")]
BANNED = ("jax", "birefnet_tpu", "tests", "triton")


def _banned(module: str) -> bool:
    return module.split(".")[0] in BANNED


def imported_modules(tree: ast.AST):
    """(line, absolute module name) of every import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_the_files_are_found():
    assert len(FILES) > 20
    assert os.path.join("birefnet_tpu_torch", "ops", "kernels",
                        "row_ln.py") in FILES
    # parallel/: its ranks import the port only (the spawned children).
    for name in ("__init__", "mesh", "ranks", "sharding"):
        assert os.path.join("birefnet_tpu_torch", "parallel",
                            f"{name}.py") in FILES


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_jax_tests_or_triton(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [f"{path}:{line} imports {mod}"
           for line, mod in imported_modules(tree) if _banned(mod)]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("source,bad", [
    ("import jax.numpy as jnp", True),
    ("def f():\n    import triton\n", True),
    ("from birefnet_tpu.ops import layers", True),
    ("from tests import conftest", True),
    ("importlib.import_module('jax')", True),
    ("import birefnet_tpu_torch.ops", False),
    ("from . import build", False),
    ("import torch", False),
])
def test_the_guard_sees_each_form(source, bad):
    mods = [m for _, m in imported_modules(ast.parse(source))]
    assert any(_banned(m) for m in mods) == bad
