"""The examples' port counterparts (``examples/*_torch.py``) run end to end
on the CPU.

Each runs in a subprocess of its own with ``--device cpu`` and with
``jax`` and ``repro`` blocked (``None`` in ``sys.modules``, as
``tests/test_torch_boundary.py`` blocks them), at the smallest of its own
flags, or, for an example without size flags (``quickstart_torch``,
``fault_tolerant_train_torch``), through its ``run`` function at smaller
arguments.  The seven start together in one module fixture (two threads
each), each under ``TIMEOUT_S``; each test then reads one example's exit
code and the line its story ends on.
"""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TIMEOUT_S = 180

# example -> (how it runs: flags after --device cpu, or a call of its run
# function; a line its story ends on)
RUNS = {
    "quickstart_torch": (
        "run('cpu', n_train=10, n_val=10, epochs=1)", "epoch    0"),
    "braille_online_learning_torch": (
        ["--epochs", "1", "--commit", "batch"], "AEU test accuracy"),
    "streaming_sessions_torch": (
        ["--epochs", "0", "--users", "4", "--bursts", "2"], "4 sessions closed"),
    "multi_model_serving_torch": (
        ["--braille-epochs", "0", "--cue-epochs", "1", "--batch", "8"],
        "one engine, two SRAM programs"),
    "lm_serve_torch": (
        ["--steps", "2", "--batch", "1", "--prompt-len", "8"], "generated (1, 2) tokens"),
    "fault_tolerant_train_torch": (
        "run('cpu', ckpt_dir={ckpt!r}, steps=(4, 6), ckpt_every=2, batch=2, seq=16)",
        "fault-tolerance drill complete"),
    "serve_braille_torch": (
        ["--epochs", "1", "--batch", "8"], "interleaved train+serve epoch"),
}

_BLOCK = """
import runpy, sys
for name in ("jax", "repro"):
    sys.modules[name] = None
sys.path[:0] = [{src!r}, {examples!r}]
"""
_FLAGS = """
sys.argv = [{path!r}, "--device", "cpu", *{flags!r}]
runpy.run_path({path!r}, run_name="__main__")
"""
_CALL = """
import {name}
{name}.{call}
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example started at once, then waited for: name -> (rc, out)."""
    ckpt = str(tmp_path_factory.mktemp("ft_ckpt"))
    procs = {}
    for name, (how, _) in RUNS.items():
        code = _BLOCK.format(src=str(ROOT / "src"), examples=str(EXAMPLES)) + (
            _FLAGS.format(path=str(EXAMPLES / f"{name}.py"), flags=how)
            if isinstance(how, list) else _CALL.format(name=name, call=how.format(ckpt=ckpt)))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
    out = {}
    for name, p in procs.items():
        try:
            text, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            text += f"\n(killed after {TIMEOUT_S} s)"
        out[name] = (p.returncode, text)
    return out


def test_every_example_has_a_port_counterpart_that_runs_here():
    jax_examples = {p.stem for p in EXAMPLES.glob("*.py") if not p.stem.endswith("_torch")}
    ported = {p.stem for p in EXAMPLES.glob("*_torch.py")}
    assert ported == set(RUNS)
    assert {f"{n}_torch" for n in jax_examples} == ported


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu_without_jax(runs, name):
    rc, text = runs[name]
    assert rc == 0, text[-4000:]
    assert RUNS[name][1] in text, text[-4000:]
