"""The port imports neither JAX, h5py nor the JAX package.

A subprocess imports ``pgdrome_tpu_torch`` and every submodule and reports
what ``sys.modules`` then holds; a source scan checks every import
statement of the package and of its scripts, ``chip_smoke.py`` and every
``run_*_torch.py`` at the root.  The one exception is ``h5py`` inside a function
body: the reader of the JAX package's HDF5 snapshots imports it when it is
called, never at import time.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pgdrome_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "h5py", "pgdrome_tpu")
LAZY_ALLOWED = ("h5py",)  # may be imported inside a function body
RUNNERS = sorted(p.name for p in ROOT.glob("run_*_torch.py"))
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")) + [
    "chip_smoke.py"] + RUNNERS
MODULES = sorted(
    p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".").removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)

_PROBE = """
import importlib, json, sys
mods = json.loads(sys.argv[1])
failed = {}
for m in mods:
    try:
        importlib.import_module(m)
    except Exception as e:
        failed[m] = repr(e)
print(json.dumps({"loaded": sorted(sys.modules), "failed": failed}))
"""


@pytest.fixture(scope="module")
def imported():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(MODULES)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_no_forbidden_module_loaded(imported):
    bad = [m for m in imported["loaded"] if _forbidden(m)]
    assert bad == []


@pytest.mark.parametrize("module", MODULES)
def test_submodule_imports(imported, module):
    assert module not in imported["failed"], imported["failed"].get(module)
    assert module in imported["loaded"]


def _imports(tree, in_function=False):
    """(module name, inside a function body) of every import statement."""
    for node in ast.iter_child_nodes(tree):
        inner = in_function or isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                 ast.Lambda))
        if isinstance(node, ast.Import):
            yield from ((a.name, in_function) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, in_function
        yield from _imports(node, inner)


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports(source):
    tree = ast.parse((ROOT / source).read_text())
    bad = [n for n, in_function in _imports(tree) if _forbidden(n)
           and not (in_function and n.split(".")[0] in LAZY_ALLOWED)]
    assert bad == []


def test_high_d_modules_covered():
    # the high-d frontier's modules are among those imported and scanned
    for module in ("pgdrome_tpu_torch.anova", "pgdrome_tpu_torch.parallel.certify"):
        assert module in MODULES
        assert module.replace(".", "/") + ".py" in SOURCES


def test_serving_modules_covered():
    # the serving analytics' modules are among those imported and scanned;
    # h5py is imported only inside the snapshot reader's body
    for module in ("pgdrome_tpu_torch.uq", "pgdrome_tpu_torch.parallel.bayes",
                   "pgdrome_tpu_torch.fem.derivative", "pgdrome_tpu_torch.convert"):
        assert module in MODULES
        assert module.replace(".", "/") + ".py" in SOURCES
    lazy = [f for n, f in _imports(ast.parse((PKG / "convert.py").read_text())) if n == "h5py"]
    assert lazy and all(lazy)


def test_runner_scripts_covered():
    # every runner script at the root is scanned, the three known ones too
    for name in ("run_frontier_torch.py", "run_nonlinear_torch.py",
                 "run_transient_goal_torch.py"):
        assert name in RUNNERS and name in SOURCES


def test_fem_modules_covered():
    # the 2D/3D FEM's modules are among those imported and scanned
    for module in ("pgdrome_tpu_torch.fem.mesh", "pgdrome_tpu_torch.fem.space",
                   "pgdrome_tpu_torch.fem.assembly", "pgdrome_tpu_torch.fem.bc",
                   "pgdrome_tpu_torch.fem.function", "pgdrome_tpu_torch.fem.interpolate",
                   "pgdrome_tpu_torch.fem.derivative", "pgdrome_tpu_torch.fem.assembly_device",
                   "pgdrome_tpu_torch.models.problems"):
        assert module in MODULES
        assert module.replace(".", "/") + ".py" in SOURCES


def test_reference_modules_covered():
    # the reference-parity layer's modules are among those imported and
    # scanned; io imports h5py only inside function bodies
    for module in ("pgdrome_tpu_torch.solver", "pgdrome_tpu_torch.model",
                   "pgdrome_tpu_torch.io", "pgdrome_tpu_torch.utils.native",
                   "pgdrome_tpu_torch.utils.pgd_config"):
        assert module in MODULES
        assert module.replace(".", "/") + ".py" in SOURCES
    lazy = [f for n, f in _imports(ast.parse((PKG / "io.py").read_text())) if n == "h5py"]
    assert lazy and all(lazy)
