"""Replica actor: hosts one copy of a deployment.

The reference's RayServeReplica (serve/_private/replica.py:250,494): wraps
the user's class/function, counts in-flight queries, applies
``reconfigure(user_config)``, and drains before shutdown.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Optional


class Replica:
    """Generic replica actor body. The deployment's callable arrives
    cloudpickled (our actor creation path ships it), so replicas never
    import user modules."""

    def __init__(self, deployment_name: str, replica_tag: str,
                 func_or_class_blob: bytes, init_args, init_kwargs,
                 user_config: Optional[dict] = None):
        import cloudpickle

        func_or_class = cloudpickle.loads(func_or_class_blob)
        self.deployment_name = deployment_name
        self.replica_tag = replica_tag
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        if inspect.isclass(func_or_class):
            self.callable = func_or_class(*init_args, **(init_kwargs or {}))
        else:
            if init_args or init_kwargs:
                raise ValueError("function deployments take no init args")
            self.callable = func_or_class
        if user_config is not None:
            self.reconfigure(user_config)

    def ready(self) -> str:
        return self.replica_tag

    def reconfigure(self, user_config) -> None:
        """Push a new user_config (serve/_private/replica.py reconfigure)."""
        fn = getattr(self.callable, "reconfigure", None)
        if fn is None:
            if user_config is not None and not callable(self.callable):
                raise ValueError(
                    f"deployment {self.deployment_name} has user_config but "
                    "no reconfigure() method")
            return
        fn(user_config)

    def handle_request(self, method: str, args, kwargs) -> Any:
        from ..core import metrics_defs as mdefs
        from ..utils import faults

        t0 = time.monotonic()
        with self._lock:
            self._ongoing += 1
            self._total += 1
        result = "ok"
        try:
            act = faults.fire("replica.exec")
            if act is not None:
                if act.mode == "stall":  # inflates service time: the
                    act.sleep()          # p99/SLO-attribution test site
                else:  # error/drop surface to the caller's api.get
                    act.raise_()
            if method in ("__call__", None):
                target = self.callable
            else:
                target = getattr(self.callable, method)
            return target(*args, **kwargs)
        except BaseException:
            result = "error"
            raise
        finally:
            with self._lock:
                self._ongoing -= 1
            try:
                mdefs.serve_requests().inc(tags={
                    "deployment": self.deployment_name, "result": result})
                mdefs.serve_request_seconds().observe(
                    time.monotonic() - t0,
                    tags={"deployment": self.deployment_name})
            except Exception:  # noqa: BLE001 — metrics never fail serving
                pass

    def metrics(self) -> dict:
        with self._lock:
            return {
                "replica_tag": self.replica_tag,
                "num_ongoing_requests": self._ongoing,
                "num_total_requests": self._total,
            }

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Wait for in-flight requests to finish (graceful shutdown)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    return True
            time.sleep(0.02)
        return False
