"""Batched and streaming AER serving runtime."""

from repro_torch.serve.batching import max_batch_for, max_sessions_for
from repro_torch.serve.engine import (
    BatchedEngine,
    ServeResult,
    ServeStats,
    SessionHandle,
    StreamStats,
)
from repro_torch.serve.guard import (
    GuardConfig,
    GuardError,
    LaneFaultError,
    MalformedEventError,
    OverloadError,
    QuotaExceededError,
    ServeError,
    ServeStatus,
    StreamContractError,
)
from repro_torch.serve.registry import DEFAULT_MODEL, ModelRegistry, ModelSpec
from repro_torch.serve.scheduler import BatchTile, BucketingScheduler, StreamPacker
from repro_torch.serve.session import SessionPool, SessionSnapshot

__all__ = [
    "BatchTile", "BatchedEngine", "BucketingScheduler", "DEFAULT_MODEL",
    "GuardConfig", "GuardError", "LaneFaultError", "MalformedEventError",
    "ModelRegistry", "ModelSpec", "OverloadError", "QuotaExceededError", "ServeError", "ServeResult",
    "ServeStats", "ServeStatus", "SessionHandle", "SessionPool",
    "SessionSnapshot", "StreamContractError", "StreamPacker", "StreamStats",
    "max_batch_for", "max_sessions_for",
]
