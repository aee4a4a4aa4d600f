"""Serve: the continuous-batching LLM engine over a paged KV cache."""

from .kv_cache import KVPagePool  # noqa: F401
from .llm import ContinuousBatcher, DynamicBatcher, LLMServer  # noqa: F401
