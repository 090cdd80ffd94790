"""Inference: the engine (prefill / decode over packed weights, slot-batched
serving, self-speculative decoding), the prefix cache and chunked prefill,
the continuous-batching scheduler, the request lifecycle and deterministic
fault injection."""

from repro_torch.infer.engine import Engine, GenerationResult, PendingAdmission
from repro_torch.infer.faults import FaultPlan, InjectedFault, StepClock
from repro_torch.infer.lifecycle import (
    QueueFullError,
    RequestLifecycle,
    RequestState,
    TransitionError,
    latency_summary,
)
from repro_torch.infer.prefix_cache import PrefixCache, PrefixHandle, model_identity
from repro_torch.infer.scheduler import Completion, DispatchError, Request, Scheduler
from repro_torch.infer.speculative import SpecConfig

__all__ = [
    "Completion",
    "DispatchError",
    "Engine",
    "FaultPlan",
    "GenerationResult",
    "InjectedFault",
    "PendingAdmission",
    "PrefixCache",
    "PrefixHandle",
    "QueueFullError",
    "Request",
    "RequestLifecycle",
    "RequestState",
    "Scheduler",
    "SpecConfig",
    "StepClock",
    "TransitionError",
    "latency_summary",
    "model_identity",
]
