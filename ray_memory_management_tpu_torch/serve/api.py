"""Serve public API: start/run/delete/shutdown + handles.

The reference's serve.api (python/ray/serve/api.py — ``serve.start``,
``serve.run(graph)``, ``serve.delete``, ``serve.shutdown``,
``serve.get_deployment``/``list_deployments``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .. import api as core_api
from .controller import CONTROLLER_NAME, get_or_create_controller
from .deployment import Application, Deployment, deployment  # noqa: F401
from .handle import DeploymentHandle

_lock = threading.Lock()
_controller = None
_handles: Dict[str, DeploymentHandle] = {}


def start(detached: bool = True, http_port: Optional[int] = None):
    """Start (or connect to) the Serve instance: ensures the controller
    actor exists; optionally starts the HTTP proxy."""
    global _controller
    with _lock:
        if _controller is None:
            _controller = get_or_create_controller()
    if http_port is not None:
        from .http_proxy import start_proxy

        start_proxy(_controller, http_port)
    return _controller


def _ctrl():
    global _controller
    with _lock:
        if _controller is None:
            _controller = get_or_create_controller()
        return _controller


def _deploy(d: Deployment) -> DeploymentHandle:
    ctrl = _ctrl()
    core_api.get(ctrl.deploy.remote(d.name, d.to_config()), timeout=120)
    return get_deployment_handle(d.name)


def run(target, *, name: Optional[str] = None) -> DeploymentHandle:
    """Deploy an Application (bound deployment graph): dependencies bound
    as init args become handles, depth-first (the reference's
    deployment-graph build, serve/_private/deployment_graph_build.py)."""
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError("serve.run expects a Deployment or Application")
    return _run_app(target)


def _run_app(app: Application) -> DeploymentHandle:
    resolved_args = tuple(
        _run_app(a) if isinstance(a, Application) else a for a in app.args)
    resolved_kwargs = {
        k: _run_app(v) if isinstance(v, Application) else v
        for k, v in app.kwargs.items()}
    d = app.deployment.options(
        init_args=resolved_args, init_kwargs=resolved_kwargs)
    return _deploy(d)


def get_deployment_handle(name: str) -> DeploymentHandle:
    ctrl = _ctrl()
    with _lock:
        h = _handles.get(name)
        if h is None:
            h = DeploymentHandle(ctrl, name)
            _handles[name] = h
        return h


def get_handle(name: str) -> DeploymentHandle:
    return get_deployment_handle(name)


def list_deployments() -> list:
    return core_api.get(_ctrl().list_deployments.remote(), timeout=30)


def status(name: str) -> Optional[dict]:
    return core_api.get(_ctrl().get_deployment_info.remote(name), timeout=30)


def delete(name: str) -> None:
    with _lock:
        h = _handles.pop(name, None)
    if h is not None and h._router_inst is not None:
        h._router_inst.shutdown()
    core_api.get(_ctrl().delete_deployment.remote(name), timeout=60)


def shutdown() -> None:
    global _controller
    with _lock:
        handles = list(_handles.values())
        _handles.clear()
        ctrl = _controller
        _controller = None
    for h in handles:
        if h._router_inst is not None:
            h._router_inst.shutdown()
    if ctrl is None:
        try:
            ctrl = core_api.get_actor(CONTROLLER_NAME)
        except Exception:
            return
    try:
        core_api.get(ctrl.shutdown.remote(), timeout=60)
        core_api.kill(ctrl)
    except Exception:
        pass
