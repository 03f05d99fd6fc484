"""The port's package boundary: no module of ``repro_torch``, not
``chip_smoke.py`` and no example counterpart (``examples/*_torch.py``)
reaches JAX or the JAX package ``repro`` when imported.

One subprocess puts ``None`` in ``sys.modules`` for ``jax`` and ``repro``
(so any import of either raises), imports every module under
``src/repro_torch/``, then ``chip_smoke`` and the example counterparts
(import only: no ``main`` runs), and reports each module's outcome; each
module is then one test.  ``chip_smoke.py`` imports the port inside its
phases, so its source, and each example's, is also scanned for an import
of either package at any depth.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
EXAMPLES = ROOT / "examples"
BLOCKED = ("jax", "repro")


def _port_modules():
    pkg = SRC / "repro_torch"
    mods = []
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


EXAMPLE_MODULES = sorted(p.stem for p in EXAMPLES.glob("*_torch.py"))
MODULES = _port_modules() + ["chip_smoke"] + EXAMPLE_MODULES

_PROBE = """
import importlib, json, sys, traceback
for name in {blocked!r}:
    sys.modules[name] = None
sys.path[:0] = [{src!r}, {root!r}, {examples!r}]
out = {{}}
for mod in {mods!r}:
    try:
        importlib.import_module(mod)
        out[mod] = None
    except BaseException:
        out[mod] = traceback.format_exc(limit=3)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def import_outcomes():
    code = _PROBE.format(blocked=BLOCKED, src=str(SRC), root=str(ROOT),
                         examples=str(EXAMPLES), mods=MODULES)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_port_module_is_probed():
    assert "repro_torch.kernels.flash_attention" in MODULES
    assert "repro_torch.models.model" in MODULES
    assert "serve_braille_torch" in MODULES and len(EXAMPLE_MODULES) == 7
    assert len(MODULES) > 40


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax_or_repro(module, import_outcomes):
    assert import_outcomes[module] is None, import_outcomes[module]


def _imported_names(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_chip_smoke_source_imports_neither_package():
    names = _imported_names("chip_smoke.py")
    assert names and not [n for n in names if n.split(".")[0] in BLOCKED]


@pytest.mark.parametrize("module", EXAMPLE_MODULES)
def test_example_source_imports_neither_package(module):
    names = _imported_names(f"examples/{module}.py")
    assert names and not [n for n in names if n.split(".")[0] in BLOCKED]
    assert "repro_torch" in {n.split(".")[0] for n in names}
