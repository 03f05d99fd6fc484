"""Model registry: runtime-reprogrammable multi-model serving state
(counterpart of :mod:`repro.serve.registry`).

:class:`ModelSpec` is one deployable model — config, quant contract (via
its backend) and weight-SRAM image, keyed by ``model_id``.
:class:`ModelRegistry` registers, looks up and hot-swaps them; models whose
configs fall in one execution bucket share one pooled backend.  A
mis-shaped image fails at the registry boundary with the per-matrix shape
diff.  In quantized mode an image is snapped onto the 8-bit SRAM grid
when it is loaded (the SPI weight reload).  A loaded image owns its
tensors: an in-place write to the caller's weights after a load (a
learner's next commit) never reaches an image already published.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.core.backend import (
    BackendLike,
    BackendPool,
    ExecutionBackend,
    RuntimeConfig,
    as_backend,
)
from repro_torch.core.rsnn import RSNNConfig

DEFAULT_MODEL = "default"

# The weight-SRAM image keys (b_fb, the e-prop feedback matrix, rides along).
SRAM_KEYS = ("w_in", "w_rec", "w_out", "b_fb")


def expected_shapes(cfg: RSNNConfig) -> Dict[str, Tuple[int, int]]:
    """Weight-SRAM image shapes a config's datapath requires."""
    shapes = {
        "w_in": (cfg.n_in, cfg.n_hid),
        "w_rec": (cfg.n_hid, cfg.n_hid),
        "w_out": (cfg.n_hid, cfg.n_out),
    }
    if cfg.eprop.feedback == "random":
        shapes["b_fb"] = (cfg.n_hid, cfg.n_out)
    return shapes


@dataclasses.dataclass
class ModelSpec:
    """One registered model; ``weights`` is the live image every launch
    reads (on the backend's device, SRAM-snapped in quantized mode)."""

    model_id: str
    cfg: RSNNConfig
    backend: ExecutionBackend
    weights: Dict[str, torch.Tensor]
    swaps: int = 0

    @property
    def quant(self):
        return self.backend.quant

    @property
    def runtime(self) -> RuntimeConfig:
        return self.backend.runtime


class ModelRegistry:
    """``model_id`` → :class:`ModelSpec`, over one shared backend pool;
    registration order is preserved (the first model is the default route)."""

    def __init__(self, pool: Optional[BackendPool] = None):
        self.pool = pool if pool is not None else BackendPool()
        self._specs: "OrderedDict[str, ModelSpec]" = OrderedDict()

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._specs

    def __len__(self) -> int:
        return len(self._specs)

    def __iter__(self) -> Iterator[str]:
        return iter(self._specs)

    def ids(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    def get(self, model_id: str) -> ModelSpec:
        spec = self._specs.get(model_id)
        if spec is None:
            raise KeyError(
                f"model {model_id!r} is not registered "
                f"(registered: {list(self._specs) or 'none'})"
            )
        return spec

    def register(
        self,
        model_id: str,
        cfg: RSNNConfig,
        params: Dict[str, torch.Tensor],
        *,
        backend: Optional[BackendLike] = None,
        runtime: Optional[RuntimeConfig] = None,
        device=None,
    ) -> ModelSpec:
        """Resolve the model's pooled backend, validate and snap its image,
        and make it routable by ``model_id``."""
        if model_id in self._specs:
            raise ValueError(
                f"model {model_id!r} already registered — deregister it "
                "first, or use update_weights() to hot-swap its SRAM image"
            )
        alpha = float(params["alpha"]) if "alpha" in params else None
        be = as_backend(cfg, backend, device=device, alpha=alpha,
                        runtime=runtime, model_id=model_id, pool=self.pool)
        image = self._validated_image(model_id, cfg, params)
        spec = ModelSpec(model_id=model_id, cfg=cfg, backend=be,
                         weights=self._snap(be, image))
        self._specs[model_id] = spec
        return spec

    def deregister(self, model_id: str) -> ModelSpec:
        spec = self.get(model_id)
        del self._specs[model_id]
        return spec

    def rebuild_backend(self, model_id: str) -> ModelSpec:
        """Replace a model's backend with a fresh one (the registry half of
        a lane restart): the old backend leaves the pool, the pool builds a
        new one for the same bucket (the same device: the bucket keys on
        it), and every spec that shared the old backend is re-pointed and
        its image re-loaded through the new one."""
        spec = self.get(model_id)
        old = spec.backend
        self.pool.discard(old)
        fresh = self.pool.get(old.cfg, old.runtime)
        for other in self._specs.values():
            if other.backend is old:
                other.backend = fresh
                other.weights = self._snap(fresh, other.weights)
        return spec

    def update_weights(self, model_id: str,
                       weights: Dict[str, torch.Tensor]) -> ModelSpec:
        """Hot-swap a model's image (partial images keep the missing
        matrices).  The image is snapped onto the SRAM grid in quantized
        mode; tiles launched before the swap keep the image they read."""
        spec = self.get(model_id)
        image = self._validated_image(model_id, spec.cfg, weights,
                                      require_all=False)
        spec.weights = {**spec.weights, **self._snap(spec.backend, image)}
        spec.swaps += 1
        return spec

    def _validated_image(self, model_id: str, cfg: RSNNConfig,
                         weights: Dict[str, torch.Tensor], *,
                         require_all: bool = True) -> Dict[str, torch.Tensor]:
        image = {k: v for k, v in weights.items() if k in SRAM_KEYS}
        want = expected_shapes(cfg)
        missing = ([k for k in want if k not in image]
                   if require_all or not image else [])
        checked = {**want, "b_fb": (cfg.n_hid, cfg.n_out)}
        diffs = [
            f"{k}: expected {checked[k]}, got {tuple(image[k].shape)}"
            for k in checked
            if k in image and tuple(image[k].shape) != checked[k]
        ]
        if missing or diffs:
            raise ValueError(
                f"weight-SRAM image mismatch for model {model_id!r} "
                f"(n_in={cfg.n_in}, n_hid={cfg.n_hid}, n_out={cfg.n_out}): "
                + "; ".join(([f"missing {missing}"] if missing else []) + diffs)
            )
        return image

    @staticmethod
    def _snap(backend: ExecutionBackend, image: Dict) -> Dict[str, torch.Tensor]:
        """The image as the spec holds it: on the backend's device, in
        tensors of its own, and on the 8-bit SRAM grid in quantized mode
        (feedback passes through)."""
        q = backend.quant
        out = {}
        for k, v in image.items():
            t = torch.as_tensor(v, dtype=torch.float32, device=backend.device)
            out[k] = (t.clone() if q is None or k == "b_fb"
                      else q.weight_spec.round_nearest(t))
        return out
