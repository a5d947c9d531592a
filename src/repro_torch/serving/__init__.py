"""Serving layer: continuous-batching engine over the paged KV pool."""
from repro_torch.serving.engine import (EngineConfig, EngineFailure,
                                        InferenceEngine)
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampler import SamplingParams, sample_batched
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

__all__ = ["EngineConfig", "EngineFailure", "InferenceEngine", "Request",
           "RequestState", "SamplingParams", "sample_batched", "Scheduler",
           "SchedulerConfig"]
