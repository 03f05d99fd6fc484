"""The port's package boundary: no module of ``repro_torch``, and not
``chip_smoke.py``, reaches JAX or the JAX package ``repro`` when imported.

One subprocess puts ``None`` in ``sys.modules`` for ``jax`` and ``repro``
(so any import of either raises), imports every module under
``src/repro_torch/`` and then ``chip_smoke`` (import only: ``main`` does not
run), and reports each module's outcome; each module is then one test.
``chip_smoke.py`` imports the port inside its phases, so its source is also
scanned for an import of either package at any depth.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
BLOCKED = ("jax", "repro")


def _port_modules():
    pkg = SRC / "repro_torch"
    mods = []
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


MODULES = _port_modules() + ["chip_smoke"]

_PROBE = """
import importlib, json, sys, traceback
for name in {blocked!r}:
    sys.modules[name] = None
sys.path[:0] = [{src!r}, {root!r}]
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
    code = _PROBE.format(blocked=BLOCKED, src=str(SRC), root=str(ROOT), mods=MODULES)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_port_module_is_probed():
    assert "repro_torch.kernels.flash_attention" in MODULES
    assert "repro_torch.models.model" in MODULES
    assert len(MODULES) > 40


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax_or_repro(module, import_outcomes):
    assert import_outcomes[module] is None, import_outcomes[module]


def test_chip_smoke_source_imports_neither_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names and not [n for n in names if n.split(".")[0] in BLOCKED]
