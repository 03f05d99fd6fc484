"""Build and load the port's hand-written CUDA kernels.

``csrc/rsnn_serve.cu`` (with the tick datapath of ``csrc/rsnn_tick.cuh``)
compiles with ``nvcc`` for Hopper (``sm_90a``) into one shared library with
a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  It builds on first use into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``); a library whose sources
and flags are unchanged is reused.

Nothing here runs at import time, and a failed build raises: there is no
fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCE = CSRC / "rsnn_serve.cu"
# -fmad=false: products are rounded before they are added (see the note in
# csrc/rsnn_tick.cuh); exact either way in quantized mode.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# {"seconds": build wall time, "ptxas": compiler resource report}; empty
# when a cached library was loaded.
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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [SOURCE]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    build_log.update(seconds=time.perf_counter() - t0, ptxas=proc.stdout.strip())
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed: nvcc exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # T, B, N, H, O, bt, threads, weights_smem, infer_all
    dims = [i32] * 9
    # alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub, quant, stream
    scalars = [f32] * 7 + [i32, i32, ptr]
    lib.rsnn_infer_launch.argtypes = [ptr] * 7 + dims + scalars
    lib.rsnn_step_sessions_launch.argtypes = [ptr] * 16 + dims + scalars
    lib.rsnn_infer_launch.restype = i32
    lib.rsnn_step_sessions_launch.restype = i32
    lib.rsnn_error_string.argtypes = [i32]
    lib.rsnn_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            out = BUILD_DIR / f"librsnn_serve-{_digest()}.so"
            if not out.exists():
                _build(out)
            _lib = _load(out)
        return _lib
