"""Public core API: init/remote/get/put/wait/actors.

Mirrors the reference's public surface (python/ray/_private/worker.py —
ray.init:1022, ray.get:2205, ray.put:2305, ray.wait:2360, ray.remote:2780;
python/ray/remote_function.py:161 RemoteFunction._remote; python/ray/actor.py:657
ActorClass._remote) with the same defaults: tasks take 1 CPU and 4 retries,
actors take 0 lifetime CPUs and 0 restarts, ``num_returns=1``.

Accelerators: ``num_gpus`` is the first-class resource (the reference's
``num_gpus``, _private/resource_spec.py:88-101); fractional values
time-share a card, integral values get ``CUDA_VISIBLE_DEVICES`` isolation.
"""

from __future__ import annotations

import functools
import os
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

from . import _worker_context
from . import serialization as ser
from .config import Config
from .core.object_ref import ObjectRef
from .exceptions import RmtError

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "ObjectRef", "nodes",
    "cluster_resources", "available_resources", "timeline", "cpp_function",
    "cpp_functions",
]

_INLINE_LIMIT_DEFAULT = 100 * 1024


def _backend():
    return _worker_context.backend()


def _inline_limit() -> int:
    rt = _worker_context.get_runtime()
    if rt is not None:
        return rt.config.max_direct_call_object_size
    proxy = _worker_context.get_proxy()
    if proxy is not None:  # worker proxy or thin client, both expose it
        return proxy.inline_limit
    return _INLINE_LIMIT_DEFAULT


def _encode_arg(value: Any):
    """Encode one call argument: refs stay refs; small values inline; large
    values are promoted to store objects (the reference inlines args up to
    100 KiB and puts the rest in plasma, serialization.py:363,411)."""
    if isinstance(value, ObjectRef):
        return ("ref", value.binary())
    data = ser.serialize(value)
    if data.total_size <= _inline_limit():
        return ("v", data.to_bytes())
    return ("ref", _backend().put_serialized_arg(data))


def _encode_call(args, kwargs):
    return (
        [_encode_arg(a) for a in args],
        {k: _encode_arg(v) for k, v in kwargs.items()},
    )


# ----------------------------------------------------------------- functions
class RemoteFunction:
    def __init__(self, fn, **options):
        self._fn = fn
        self._options = options
        self._fn_id = uuid.uuid4().bytes
        self._fn_blob: Optional[bytes] = None
        self._blob_lock = threading.Lock()
        # everything but args/kwargs is fixed per RemoteFunction; building
        # (and validating) it once keeps .remote() off the hot path's back
        self._payload_template: Optional[dict] = None
        functools.update_wrapper(self, fn)

    def options(self, **options) -> "RemoteFunction":
        merged = {**self._options, **options}
        clone = RemoteFunction(self._fn, **merged)
        return clone

    def _blob(self) -> bytes:
        with self._blob_lock:
            if self._fn_blob is None:
                self._fn_blob = ser.dumps_function(self._fn)
            return self._fn_blob

    def _template(self) -> dict:
        tmpl = self._payload_template
        if tmpl is None:
            opts = self._options
            resources: Dict[str, float] = dict(opts.get("resources") or {})
            resources["CPU"] = opts.get("num_cpus", 1.0)
            if opts.get("num_gpus"):
                resources["GPU"] = opts["num_gpus"]
            if opts.get("memory"):
                resources["memory"] = opts["memory"]
            tmpl = {
                "name": opts.get("name",
                                 getattr(self._fn, "__name__", "task")),
                "fn_id": self._fn_id,
                "fn_blob": self._blob(),
                "num_returns": opts.get("num_returns", 1),
                "resources": resources,
                "strategy": _resolve_strategy(opts),
                "max_retries": opts.get("max_retries", 4),
                "retry_exceptions": bool(opts.get("retry_exceptions",
                                                  False)),
                "runtime_env": _validated_runtime_env(opts),
            }
            self._payload_template = tmpl
        return tmpl

    def remote(self, *args, **kwargs):
        enc_args, enc_kwargs = _encode_call(args, kwargs)
        payload = dict(self._template())
        payload["args"] = enc_args
        payload["kwargs"] = enc_kwargs
        return_ids = _backend().submit_task(payload)
        # adopt: submit pre-registered one handle ref per return id
        refs = [ObjectRef(oid, _owner(), adopt=_owner() is not None)
                for oid in return_ids]
        return refs[0] if len(refs) == 1 else refs

    def bind(self, *args, **kwargs):
        """A ``dag.FunctionNode`` calling this function on the bound
        arguments (DAG nodes among them resolve first). The JAX package's
        ``dag`` documents ``fn.bind(...)``, but its remote functions have
        no ``bind``."""
        from .dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            "remote functions must be called with .remote() "
            f"(use {self.__name__}.remote(...))"
        )

    def __reduce__(self):
        # Remote functions are captured in other tasks' closures; rebuild with
        # the same fn_id so worker-side function caches stay warm.
        return (_rebuild_remote_function,
                (self._fn, self._options, self._fn_id))


def _rebuild_remote_function(fn, options, fn_id):
    rf = RemoteFunction(fn, **options)
    rf._fn_id = fn_id
    return rf


def _validated_runtime_env(opts) -> Optional[dict]:
    env = opts.get("runtime_env")
    if not env:
        return None
    from .runtime_env import validate

    return validate(env)


def _resolve_strategy(opts) -> Any:
    strategy = opts.get("scheduling_strategy")
    pg = opts.get("placement_group")
    if pg is not None:
        from .core.scheduling_strategies import PlacementGroupSchedulingStrategy

        return PlacementGroupSchedulingStrategy(
            pg, opts.get("placement_group_bundle_index", -1)
        )
    return strategy


def _owner():
    """Driver-side refs participate in refcounting; worker-side are bare."""
    return _worker_context.get_runtime()


# --------------------------------------------------------- C++ task plane
class CppFunction:
    """Handle to a function implemented by a connected C++ executor
    process (the worker-side C++ API — reference: cpp/include/ray/api.h
    ``ray::Task(fn).Remote()``; here the executor registers its function
    names over the client protocol and long-polls for work).

    Args are raw ``bytes`` (the cross-language boundary moves opaque
    buffers); results come back as ``bytes`` through ordinary
    ObjectRefs — ``rmt.get`` works unchanged."""

    def __init__(self, name: str, num_returns: int = 1):
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1) -> "CppFunction":
        return CppFunction(self._name, num_returns)

    def remote(self, *args) -> Union[ObjectRef, List[ObjectRef]]:
        from .client.server import submit_cpp_task

        owner = _owner()
        if owner is None:
            raise RmtError("cpp_function requires the in-process driver "
                           "(thin clients use the call_cpp verb)")
        oids = submit_cpp_task(
            self._name, [bytes(a) for a in args],
            num_returns=self._num_returns, adopt=True)
        refs = [ObjectRef(oid, owner, adopt=True) for oid in oids]
        return refs[0] if len(refs) == 1 else refs


def cpp_function(name: str) -> CppFunction:
    """A handle that dispatches to a registered C++ executor function."""
    return CppFunction(name)


def cpp_functions() -> List[str]:
    """Names currently served by connected C++ executors."""
    from .client.server import cpp_function_names

    return cpp_function_names()


# ------------------------------------------------------------------- actors
class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1) -> "ActorMethod":
        return ActorMethod(self._handle, self._name, num_returns)

    def bind(self, *args, **kwargs):
        """A ``dag.ClassMethodNode`` calling this method (see
        ``RemoteFunction.bind``)."""
        from .dag import ClassMethodNode

        return ClassMethodNode(self, args, kwargs)

    def remote(self, *args, **kwargs):
        enc_args, enc_kwargs = _encode_call(args, kwargs)
        payload = {
            "actor_id": self._handle._actor_id,
            "method": self._name,
            "args": enc_args,
            "kwargs": enc_kwargs,
            "num_returns": self._num_returns,
        }
        return_ids = _backend().submit_actor_task(payload)
        # adopt: submit pre-registered one handle ref per return id
        refs = [ObjectRef(oid, _owner(), adopt=_owner() is not None)
                for oid in return_ids]
        return refs[0] if len(refs) == 1 else refs


class ActorHandle:
    def __init__(self, actor_id: bytes, class_name: str = "Actor"):
        self._actor_id = actor_id
        self._class_name = class_name

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("__"):  # dunder lookups are never actor methods
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:8]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name))

    @property
    def _actor_id_hex(self) -> str:
        return self._actor_id.hex()


class ActorClass:
    def __init__(self, cls, **options):
        self._cls = cls
        self._options = options
        self._cls_id = uuid.uuid4().bytes
        self._cls_blob: Optional[bytes] = None
        self._blob_lock = threading.Lock()
        functools.update_wrapper(self, cls, updated=[])

    def options(self, **options) -> "ActorClass":
        merged = {**self._options, **options}
        clone = ActorClass(self._cls, **merged)
        clone._cls_id = self._cls_id  # same code; workers can reuse the cache
        clone._cls_blob = self._cls_blob
        return clone

    def _blob(self) -> bytes:
        with self._blob_lock:
            if self._cls_blob is None:
                self._cls_blob = ser.dumps_function(self._cls)
            return self._cls_blob

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._options
        enc_args, enc_kwargs = _encode_call(args, kwargs)
        resources: Dict[str, float] = dict(opts.get("resources") or {})
        # Actors hold 0 CPUs by default while alive (actor.py option
        # handling): many lightweight actors can share a node.
        if opts.get("num_cpus") is not None:
            resources["CPU"] = opts["num_cpus"]
        if opts.get("num_gpus"):
            resources["GPU"] = opts["num_gpus"]
        payload = {
            "name": opts.get("name", self._cls.__name__),
            "cls_id": self._cls_id,
            "cls_blob": self._blob(),
            "args": enc_args,
            "kwargs": enc_kwargs,
            "resources": resources,
            "strategy": _resolve_strategy(opts),
            "max_restarts": opts.get("max_restarts", 0),
            "max_task_retries": opts.get("max_task_retries", 0),
            "max_concurrency": opts.get("max_concurrency", 1),
            "detached": opts.get("lifetime") == "detached",
            "registered_name": opts.get("name"),
            "placement": opts.get("placement"),
            "runtime_env": _validated_runtime_env(opts),
        }
        pg = opts.get("placement_group")
        if pg is not None:
            payload["placement"] = (
                pg.id, opts.get("placement_group_bundle_index", -1)
            )
        actor_id = _backend().create_actor(payload)
        return ActorHandle(actor_id, self._cls.__name__)

    def __call__(self, *args, **kwargs):
        raise TypeError("actor classes must be instantiated with .remote()")

    def __reduce__(self):
        return (_rebuild_actor_class,
                (self._cls, self._options, self._cls_id))


def _rebuild_actor_class(cls, options, cls_id):
    ac = ActorClass(cls, **options)
    ac._cls_id = cls_id
    return ac


# ---------------------------------------------------------------- decorator
def remote(*args, **options):
    """``@remote`` / ``@remote(num_cpus=..., num_gpus=..., ...)`` for
    functions and classes (worker.py:2780 in the reference)."""

    def decorate(obj):
        if isinstance(obj, type):
            return ActorClass(obj, **options)
        return RemoteFunction(obj, **options)

    if len(args) == 1 and callable(args[0]) and not options:
        return decorate(args[0])
    if args:
        raise TypeError("remote() takes keyword options only")
    return decorate


def method(num_returns: int = 1):
    """Decorator recording per-method defaults (reference @ray.method)."""

    def wrap(fn):
        fn.__rmt_num_returns__ = num_returns
        return fn

    return wrap


# ------------------------------------------------------------------ objects
def put(value: Any, *, device: bool = False) -> ObjectRef:
    """Store a value and return its ref. ``device=True`` pins a
    torch.Tensor in the calling process's device store — the ref points at
    live device memory, same-process gets are zero-copy, and remote readers pull a
    host copy materialized on demand (SURVEY.md §7; net-new vs the
    reference's host-only plasma)."""
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    if device:
        oid = _backend().put_device_object(value)
    else:
        oid = _backend().put_object(value)
    # in a worker the proxy IS the reference counter for its own puts
    # (creator-owns, reference_count.h:39); on the driver _owner() is the
    # runtime as before
    owner = _owner()
    if owner is None and not device:
        b = _backend()
        if hasattr(b, "add_local_ref"):
            owner = b
    return ObjectRef(oid, owner)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None, consume: bool = False):
    """``consume=True`` is the device-tier donation read: the caller
    asserts it is the LAST reader of a device object, the store drops
    its pin and hands over the live tensor so the caller may update it
    in place (the torch reading of buffer donation) without a copy. The
    ref is dead for device reads afterwards; non-device objects ignore
    the flag."""
    single = isinstance(refs, ObjectRef)
    if not single and not isinstance(refs, (list, tuple)):
        raise TypeError(
            f"get() expects an ObjectRef or a list of them, got {type(refs)}"
        )
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRefs, got {type(r)}")
    ids = [r.binary() for r in ref_list]
    if consume:
        values = _backend().get_objects(ids, timeout, consume=True)
    else:
        values = _backend().get_objects(ids, timeout)
    return values[0] if single else values


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    ids = [r.binary() for r in refs]
    by_id = {r.binary(): r for r in refs}
    ready, not_ready = _backend().wait(ids, num_returns, timeout, fetch_local)
    ready_set = set(ready[:num_returns])
    ready_refs = [by_id[i] for i in ready[:num_returns]]
    rest = [by_id[i] for i in ids if i not in ready_set]
    return ready_refs, rest


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _backend().kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    _backend().cancel_task(ref.binary(), force)


def get_actor(name: str) -> ActorHandle:
    rt = _worker_context.get_runtime()
    if rt is not None:
        rec = rt.gcs.get_named_actor(name)
        if rec is None:
            raise ValueError(f"no actor named {name!r}")
        return ActorHandle(rec.actor_id.binary(), rec.spec.name)
    proxy = _worker_context.get_proxy()
    if proxy is None:
        raise RmtError("not initialized")
    actor_id = proxy.get_named_actor(name)
    return ActorHandle(actor_id, name)


# -------------------------------------------------------------------- init
_init_lock = threading.Lock()


def init(
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    num_nodes: int = 1,
    object_store_memory: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    _config: Optional[Config] = None,
):
    """Start an in-process cluster with ``num_nodes`` virtual nodes (each a
    NodeManager + store + worker pool). The multi-node shape exists for
    scheduling/FT semantics and tests (cluster_utils.py analog); other
    hosts join as node agents (``core/node_agent.py``;
    ``Runtime.add_remote_node_process`` starts one on this host)."""
    from .core.runtime import Runtime

    with _init_lock:
        if _worker_context.get_runtime() is not None:
            if ignore_reinit_error:
                return _worker_context.get_runtime()
            raise RmtError("already initialized (use shutdown() first)")
        cfg = _config or Config()
        if object_store_memory:
            cfg.object_store_memory = object_store_memory
        if num_cpus is None:
            num_cpus = max(4, os.cpu_count() or 4)
        if num_gpus is None:
            num_gpus = _detect_gpus()
        node_spec = {
            "num_cpus": num_cpus,
            "num_gpus": num_gpus,
            "resources": resources,
        }
        rt = Runtime(cfg, [dict(node_spec) for _ in range(num_nodes)],
                     namespace=namespace)
        _worker_context.set_runtime(rt)
        return rt


def _detect_gpus() -> int:
    """GPU autodetection (_private/resource_spec.py:273): honor
    CUDA_VISIBLE_DEVICES, else count the devices of an ALREADY-INITIALIZED
    CUDA context. Never import torch or initialize CUDA here: that would
    create a context on every card just because the scheduler asked how
    many exist, and a process whose CUDA is initialized can no longer fork
    workers safely."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return len([c for c in env.split(",") if c.strip() != ""])
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    return torch.cuda.device_count()


def shutdown() -> None:
    rt = _worker_context.get_runtime()
    if rt is not None:
        rt.shutdown()
        _worker_context.set_runtime(None)


def is_initialized() -> bool:
    return _worker_context.get_runtime() is not None


def nodes() -> List[dict]:
    rt = _worker_context.get_runtime()
    if rt is None:
        return []
    return [
        {
            "NodeID": info.node_id.hex(),
            "Alive": info.alive,
            "Resources": info.resources.total.to_dict(),
            "StoreName": info.store_name,
            "Labels": info.labels,
        }
        for info in rt.gcs.nodes.values()
    ]


def cluster_resources() -> Dict[str, float]:
    return _worker_context.get_runtime().scheduler.cluster_resources()


def available_resources() -> Dict[str, float]:
    return _worker_context.get_runtime().scheduler.available_resources()


def timeline(filename: Optional[str] = None):
    from .utils.timeline import dump_timeline

    return dump_timeline(filename)
