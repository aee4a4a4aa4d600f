"""Serve library: online model serving over the actor runtime.

The reference's ``ray.serve`` (python/ray/serve/ — controller actor,
deployment/replica reconciler, router with in-flight caps, long-poll
config push, autoscaling, HTTP proxies), with the continuous-batching
LLM engine over a paged KV cache.

The LLM names load on first use: ``serve.llm`` imports torch, which a
replica of a plain deployment never needs (a fresh worker's first
``import torch`` costs seconds).
"""

from .api import (  # noqa: F401
    delete,
    get_deployment_handle,
    get_handle,
    list_deployments,
    run,
    shutdown,
    start,
    status,
)
from .deployment import (  # noqa: F401
    Application,
    AutoscalingConfig,
    Deployment,
    deployment,
)
from .handle import (  # noqa: F401
    BackpressureTimeout,
    DeploymentHandle,
    NoReplicasError,
)

_LAZY = {
    "KVPagePool": "kv_cache",
    "ContinuousBatcher": "llm",
    "DynamicBatcher": "llm",
    "LLMServer": "llm",
    "llm_deployment": "llm",
    "pack_weights": "llm",
    "unpack_weights": "llm",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
