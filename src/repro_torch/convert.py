"""Parameter conversion from the JAX package's layout to the port's.

RSNN (:func:`params_from_jax`): both packages key weights alike
(``w_in (N_in, H)``, ``w_rec (H, H)``, ``w_out (H, O)``, scalar ``alpha``,
optional ``b_fb (H, O)``), so the conversion is a float32 copy of each
array onto ``device`` (``None`` means ``"cuda"``, and raises without a
card).  The JAX side hands its
parameters over as NumPy arrays (``{k: np.asarray(v) for k, v in
params.items()}``); this module imports nothing of it.

Optimizer state (:func:`opt_state_from_jax`): the JAX package's
``EpropSGD`` state ``{"count": int32 (), "acc": {...}, "mu": {...}}`` (each
present only when its mode is on) maps key for key onto the port's, so a
run of either package can start from the other's state.

LM (:func:`lm_params_from_jax`): the port keeps the JAX parameter tree's
layout (nested dicts, the prefix list, the stacked layer axis), so the
conversion is a tree map that checks every key, shape and dtype against
the config's tree, each leaf against its own dtype there (a MoE router,
and a Mamba mixer's ``dt_bias``, ``a_log`` and ``d_skip``, are f32 in
every model dtype, as the JAX package draws them).  A
bf16 JAX array arrives as an ``ml_dtypes.bfloat16`` NumPy array, which
``torch.from_numpy`` refuses; it goes through float32 and back, which is
exact.  The LM's AdamW state (:func:`adamw_state_from_jax`) maps leaf for
leaf the same way, its moments checked as f32 trees of the parameters'
shapes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

PARAM_KEYS = ("w_in", "w_rec", "w_out", "alpha", "b_fb")


def params_from_jax(params: Dict[str, np.ndarray], device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """Map the JAX package's parameters (as NumPy arrays) onto float32
    tensors on ``device`` (the card unless the caller passes ``"cpu"``);
    unknown keys raise."""
    unknown = set(params) - set(PARAM_KEYS)
    if unknown:
        raise ValueError(f"unknown parameter keys {sorted(unknown)}")
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
        for k, v in params.items()
    }


def opt_state_from_jax(state: Dict[str, Any], device: DeviceLike = None
                       ) -> Dict[str, Any]:
    """Map the JAX package's ``EpropSGD`` state (NumPy leaves) onto the
    port's on ``device`` (the card unless the caller passes ``"cpu"``): the
    sample counter stays an exact int32, the residuals ``acc`` and the
    momentum ``mu`` are float32 copies keyed like the weights.  Unknown
    keys raise."""
    unknown = set(state) - {"count", "acc", "mu"}
    if unknown:
        raise ValueError(f"unknown optimizer state keys {sorted(unknown)}")
    dev = resolve_device(device)
    out: Dict[str, Any] = {
        "count": torch.from_numpy(np.array(state["count"], dtype=np.int32)).to(dev)}
    for key in ("acc", "mu"):
        if key in state:
            out[key] = params_from_jax(state[key], device=dev)
    return out


def _lm_tree_from_jax(tree: Any, cfg, dev: torch.device, dtype: Optional[str],
                      what: str) -> Dict[str, Any]:
    """A JAX tree of NumPy leaves shaped like ``cfg``'s parameter tree, as
    tensors on ``dev``, each of ``dtype`` or (``None``) of its own leaf's
    dtype in ``cfg``'s tree; every key, shape and dtype checked."""
    from repro_torch.models.transformer import param_shapes

    def conv(src, want, path):
        if want is None:     # an unscanned stack's "scan": JAX keeps an empty dict
            if src not in (None, {}):
                raise ValueError(f"{path}: expected an empty subtree")
            return None
        if isinstance(want, dict):
            if not isinstance(src, dict):
                raise ValueError(f"{path}: expected a dict")
            unknown, missing = set(src) - set(want), set(want) - set(src)
            if unknown or missing:
                raise ValueError(f"{path}: unknown keys {sorted(unknown)}, "
                                 f"missing keys {sorted(missing)}")
            return {k: conv(src[k], want[k], f"{path}/{k}") for k in want}
        if isinstance(want, list):
            if not isinstance(src, (list, tuple)) or len(src) != len(want):
                raise ValueError(f"{path}: expected a list of {len(want)}")
            return [conv(s, w, f"{path}/{i}") for i, (s, w) in enumerate(zip(src, want))]
        arr = np.asarray(src)
        if arr.shape != tuple(want.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected {tuple(want.shape)}")
        want_dtype = want.dtype if dtype is None else getattr(torch, dtype)
        name = str(want_dtype).removeprefix("torch.")
        if arr.dtype.name != name:
            raise ValueError(f"{path}: dtype {arr.dtype.name}, expected {name}")
        return torch.from_numpy(arr.astype(np.float32)).to(dev, dtype=want_dtype)

    return conv(tree, param_shapes(cfg), what)


def lm_params_from_jax(tree: Dict[str, Any], cfg, device: DeviceLike = None
                       ) -> Dict[str, Any]:
    """Map the JAX package's LM parameter tree (NumPy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``) onto the port's tree on
    ``device`` (the card unless the caller passes ``"cpu"``).  Unknown or
    missing keys, and leaves whose shape or dtype differ from ``cfg``'s
    tree, raise ``ValueError``."""
    return _lm_tree_from_jax(tree, cfg, resolve_device(device), None, "params")


def adamw_state_from_jax(state: Dict[str, Any], cfg, device: DeviceLike = None
                         ) -> Dict[str, Any]:
    """Map the JAX package's AdamW state ``{"mu", "nu", "step"}`` (NumPy
    leaves) onto the port's on ``device`` (the card unless the caller
    passes ``"cpu"``): ``mu`` and ``nu`` f32 trees checked as
    :func:`lm_params_from_jax` checks the parameters, ``step`` an exact
    int32 scalar.  Unknown or missing keys raise."""
    if set(state) != {"mu", "nu", "step"}:
        raise ValueError(f"AdamW state keys {sorted(state)}, expected "
                         f"['mu', 'nu', 'step']")
    dev = resolve_device(device)
    return {"mu": _lm_tree_from_jax(state["mu"], cfg, dev, "float32", "mu"),
            "nu": _lm_tree_from_jax(state["nu"], cfg, dev, "float32", "nu"),
            "step": torch.from_numpy(np.array(state["step"], dtype=np.int32)).to(dev)}
