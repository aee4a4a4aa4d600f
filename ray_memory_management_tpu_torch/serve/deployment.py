"""Deployment definition API: @serve.deployment, .bind(), .deploy().

The reference's Deployment class + decorator (python/ray/serve/deployment.py
— options/num_replicas/user_config/max_concurrent_queries,
``Deployment.bind`` building a deployment graph node, `.deploy()` pushing
to the controller) and AutoscalingConfig
(serve/config.py AutoscalingConfig).
"""

from __future__ import annotations

import hashlib
import io
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import cloudpickle

from .. import serialization as ser


class _DigestPickler(cloudpickle.CloudPickler):
    """Pickles a tensor as its dtype, shape and raw bytes: torch's own
    reduce goes through ``torch.save``, whose bytes differ between two
    pickles of equal tensors."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous()
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
            return tuple, ((str(t.dtype), tuple(t.shape), raw),)
        return super().reducer_override(obj)


def _init_digest(init_args: Tuple, init_kwargs: Dict) -> str:
    """A digest of a deployment's init arguments: equal for equal values
    of any type (numpy arrays and tensors included), so the controller
    decides whether a redeploy changed them without ``!=`` on values
    whose ``==`` is elementwise."""
    buf = io.BytesIO()
    _DigestPickler(buf, protocol=5).dump((init_args, init_kwargs))
    return hashlib.sha256(buf.getbuffer()).hexdigest()


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 1
    target_num_ongoing_requests_per_replica: float = 1.0

    def to_dict(self) -> dict:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "target_num_ongoing_requests_per_replica":
                self.target_num_ongoing_requests_per_replica,
        }


class Application:
    """A bound deployment (the reference's DAGNode from
    ``Deployment.bind``): deployment + init args, possibly referencing
    other bound deployments, resolved to handles at deploy time."""

    def __init__(self, deployment: "Deployment", args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Deployment:
    def __init__(self, func_or_class: Any, name: str,
                 num_replicas: int = 1,
                 init_args: Tuple = (),
                 init_kwargs: Optional[Dict] = None,
                 user_config: Any = None,
                 max_concurrent_queries: int = 100,
                 autoscaling_config: Optional[AutoscalingConfig] = None,
                 ray_actor_options: Optional[Dict] = None,
                 placement_hint: Optional[str] = None):
        self._func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas
        self.init_args = init_args
        self.init_kwargs = init_kwargs or {}
        self.user_config = user_config
        self.max_concurrent_queries = max_concurrent_queries
        self.autoscaling_config = autoscaling_config
        self.ray_actor_options = ray_actor_options
        # hex object id whose holding node/tier new replicas should
        # prefer (e.g. shipped weights pinned in a device tier)
        self.placement_hint = placement_hint

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                init_args: Optional[Tuple] = None,
                init_kwargs: Optional[Dict] = None,
                user_config: Any = None,
                max_concurrent_queries: Optional[int] = None,
                autoscaling_config: Optional[AutoscalingConfig] = None,
                ray_actor_options: Optional[Dict] = None,
                placement_hint: Optional[str] = None) -> "Deployment":
        return Deployment(
            self._func_or_class,
            name if name is not None else self.name,
            num_replicas if num_replicas is not None else self.num_replicas,
            init_args if init_args is not None else self.init_args,
            init_kwargs if init_kwargs is not None else self.init_kwargs,
            user_config if user_config is not None else self.user_config,
            max_concurrent_queries if max_concurrent_queries is not None
            else self.max_concurrent_queries,
            autoscaling_config if autoscaling_config is not None
            else self.autoscaling_config,
            ray_actor_options if ray_actor_options is not None
            else self.ray_actor_options,
            placement_hint if placement_hint is not None
            else self.placement_hint,
        )

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def deploy(self, *init_args, **init_kwargs):
        """Imperative deploy (the reference's 1.x-style API, still present
        at serve/deployment.py deploy)."""
        from . import api as serve_api

        d = self
        if init_args or init_kwargs:
            # only override what was actually passed; deploy(x) must not
            # clobber decorator-supplied init_kwargs with {}
            d = self.options(
                init_args=init_args if init_args else None,
                init_kwargs=init_kwargs if init_kwargs else None)
        return serve_api._deploy(d)

    def get_handle(self):
        from . import api as serve_api

        return serve_api.get_deployment_handle(self.name)

    def to_config(self) -> dict:
        cfg = {
            "func_or_class_blob": ser.dumps_function(self._func_or_class),
            "num_replicas": self.num_replicas,
            "init_args": self.init_args,
            "init_kwargs": self.init_kwargs,
            "init_digest": _init_digest(self.init_args, self.init_kwargs),
            "user_config": self.user_config,
            "max_concurrent_queries": self.max_concurrent_queries,
            "actor_options": self.ray_actor_options,
            "autoscaling": self.autoscaling_config.to_dict()
            if self.autoscaling_config else None,
            "placement_hint": self.placement_hint,
        }
        if cfg["autoscaling"]:
            # autoscaler owns num_replicas between min and max
            cfg["num_replicas"] = max(
                self.autoscaling_config.min_replicas, 1)
        return cfg


def deployment(_func_or_class: Optional[Callable] = None, *,
               name: Optional[str] = None,
               num_replicas: int = 1,
               init_args: Tuple = (),
               init_kwargs: Optional[Dict] = None,
               user_config: Any = None,
               max_concurrent_queries: int = 100,
               autoscaling_config: Optional[Any] = None,
               ray_actor_options: Optional[Dict] = None,
               placement_hint: Optional[str] = None):
    """``@serve.deployment`` / ``@serve.deployment(num_replicas=...)``."""
    if autoscaling_config is not None and isinstance(
            autoscaling_config, dict):
        autoscaling_config = AutoscalingConfig(**autoscaling_config)

    def wrap(func_or_class):
        return Deployment(
            func_or_class,
            name or getattr(func_or_class, "__name__", "deployment"),
            num_replicas=num_replicas,
            init_args=init_args,
            init_kwargs=init_kwargs,
            user_config=user_config,
            max_concurrent_queries=max_concurrent_queries,
            autoscaling_config=autoscaling_config,
            ray_actor_options=ray_actor_options,
            placement_hint=placement_hint,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
