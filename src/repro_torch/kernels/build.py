"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source (the serving kernels of ``rsnn_serve.cu``, the
training kernels of ``rsnn_train.cu`` and their triangular-surrogate
instantiations of ``rsnn_train_tri.cu``, both on ``rsnn_train.cuh``, all
three on the tick datapath of ``rsnn_tick.cuh``, the attention forward of
``flash_attention.cu`` and its backward of ``flash_attention_bwd.cu``, both
on ``flash_common.cuh``)
compiles with ``nvcc`` for Hopper (``sm_90a``; the RSNN sources with
``-fmad=false``), one ``nvcc`` per source, all started together, and links
into one shared library with a plain C interface, loaded with ``ctypes`` —
no PyTorch headers, so a build takes seconds, and no ``-lcuda``: the
bf16 attention kernels reach libcuda's ``cuTensorMapEncodeTiled``
through the runtime's ``cudaGetDriverEntryPoint``.  It builds on first use into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``);
a library whose sources and flags are unchanged (the digest covers every
source and header) is reused.

Nothing here runs at import time, and a failed build raises: there is no
fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# -fmad=false for the RSNN sources: products are rounded before they are
# added (see the note in csrc/rsnn_tick.cuh), bit for bit with the plain
# version in quantized mode.  The attention source is not on that path and
# builds with contraction on.
EXACT_SOURCES = ("rsnn_serve.cu", "rsnn_train.cu", "rsnn_train_tri.cu")


def _flags(src: Path):
    return (*NVCC_FLAGS, "-fmad=false") if src.name in EXACT_SOURCES else NVCC_FLAGS

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# {"seconds": build wall time, "ptxas": compiler resource report}; empty
# when a cached library was loaded (its report is saved beside it:
# ptxas_log).
build_log: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build from source on a machine "
        "with the CUDA toolkit (use device='cpu' for the plain versions)"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + _sources():
        h.update(" ".join(_flags(path)).encode())
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc_all(cmds) -> str:
    """Run the nvcc commands side by side and return their output; raise
    with it when one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log = "\n".join(p.communicate()[0].strip() for p in procs)
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        raise RuntimeError(f"kernel build failed: nvcc exited {bad[0]}\n{log}")
    return log


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [f"{tmp}/{src.stem}.o" for src in _sources()]
        log = _nvcc_all([[nvcc, *_flags(src), "-c", "-o", o, str(src)]
                         for src, o in zip(_sources(), objs)])
        _nvcc_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}/lib.so",
                    *objs]])
        build_log.update(seconds=time.perf_counter() - t0, ptxas=log)
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(f"{tmp}/lib.so", out)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # T, B, N, H, O, rows, threads, Tc, weights_smem, infer_all; the
    # plan's shared-memory bytes
    dims = [i32] * 10 + [ctypes.c_longlong]
    # alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub, quant, stream
    scalars = [f32] * 7 + [i32, i32, ptr]
    lib.rsnn_infer_launch.argtypes = [ptr] * 7 + dims + scalars
    lib.rsnn_step_sessions_launch.argtypes = [ptr] * 16 + dims + scalars
    lib.rsnn_infer_launch.restype = i32
    lib.rsnn_step_sessions_launch.restype = i32
    # rsnn_forward: 4 inputs, 7 outputs; T, B, N, H, O, rows, threads, Tl,
    # weights_smem, rows_smem; the plan's shared-memory bytes; 7 datapath
    # floats, reset_sub, quant; the surrogate's bw_vth, tri, gamma,
    # inv_vth; stream
    surrogate = [f32, i32, f32, f32]
    lib.rsnn_forward_launch.argtypes = (
        [ptr] * 11 + [i32] * 10 + [ctypes.c_longlong] + [f32] * 7
        + [i32, i32] + surrogate + [ptr])
    # rsnn_train: 7 inputs, 5 traces, g, dw_part, dw, dw_codes, acc_y,
    # n_spk; T, B, N, H, O, threads, cluster, ticks, weights_smem,
    # traces_smem, infer_all; smem bytes; datapath scalars, then the
    # surrogate's four, y_scale, target_amp, err_softmax, the commit grid's
    # lsb and bits, the roles' clock buffer, stream
    lib.rsnn_train_launch.argtypes = (
        [ptr] * 18 + [i32] * 11 + [ctypes.c_longlong] + [f32] * 7 + [i32, i32]
        + surrogate + [f32, f32, i32, f32, i32, ptr, ptr])
    # rsnn_train_exact: 7 inputs, alpha, dw_part, dw, dw_codes, acc_y,
    # n_spk; T, B, N, H, O, threads, cluster, groups, slots, ticks, inputs,
    # g_in, g_rec, g_out, lines, weights_smem, infer_all; smem bytes; then
    # as rsnn_train, with the roles' clock buffer before the stream
    lib.rsnn_train_exact_launch.argtypes = (
        [ptr] * 13 + [i32] * 17 + [ctypes.c_longlong] + [f32] * 7 + [i32, i32]
        + surrogate + [f32, f32, i32, f32, i32, ptr, ptr])
    # eprop_update: 6 inputs, g, dw_part, dw; T, B, N, H, O; kappa, stream
    lib.eprop_update_launch.argtypes = [ptr] * 9 + [i32] * 5 + [f32, ptr]
    # flash_attention: q, k, v, o, lse and the f32 output (null: neither
    # written); bf16, B, Sq, Skv, H, Hkv, the q/k width D and the v width
    # DV; the batch, sequence and head strides of q, k and v; kv_len,
    # causal, scale; the plan's grid, threads and shared-memory bytes;
    # stream
    lib.flash_attention_launch.argtypes = (
        [ptr] * 6 + [i32] * 8 + [ctypes.c_longlong] * 9
        + [i32, i32, f32, i32, i32, i32, ctypes.c_longlong, ptr])
    # flash_attention_bwd: q, k, v, o, dO, lse, lse2, delta, dq, dk, dv;
    # bf16, B, Sq, Skv, H, Hkv, D, DV; the strides of q, k and v; causal,
    # scale; the plan's padded rows, delta blocks, KV tiles, q blocks,
    # heads a dQ block, threads, the dK/dV and dQ shared-memory bytes;
    # stream
    lib.flash_attention_bwd_launch.argtypes = (
        [ptr] * 11 + [i32] * 8 + [ctypes.c_longlong] * 9
        + [i32, f32] + [i32] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ptr])
    for fn in (lib.rsnn_forward_launch, lib.rsnn_train_launch,
               lib.rsnn_train_exact_launch, lib.eprop_update_launch, lib.flash_attention_launch,
               lib.flash_attention_bwd_launch):
        fn.restype = i32
    lib.rsnn_error_string.argtypes = [i32]
    lib.rsnn_error_string.restype = ctypes.c_char_p
    return lib


def _library_path() -> Path:
    return BUILD_DIR / f"librsnn_kernels-{_digest()}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            out = _library_path()
            if not out.exists():
                _build(out)
            _lib = _load(out)
        return _lib


def ptxas_log() -> str:
    """ptxas's resource report for the library of these sources: this
    process's build's, or the one saved beside a cached library; empty
    when neither exists."""
    if "ptxas" in build_log:
        return str(build_log["ptxas"])
    saved = _library_path().with_suffix(".ptxas.txt")
    return saved.read_text() if saved.exists() else ""


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (its mangled name) of a ``-Xptxas -v`` log: the
    ``registers`` it uses and its ``spill_stores`` and ``spill_loads``
    bytes."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = dict(registers=0, spill_stores=0, spill_loads=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out
