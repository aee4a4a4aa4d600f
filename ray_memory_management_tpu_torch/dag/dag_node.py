"""DAG node types and execution.

Mirrors the reference's node taxonomy (python/ray/dag/: DAGNode base
dag_node.py:23, FunctionNode, ClassMethodNode, InputNode/InputAttributeNode
input_node.py, MultiOutputNode output_node.py) re-founded on this runtime's
task/actor API. Execution is owner-side: one pass over the graph submits
every task with parent ObjectRefs as arguments — the runtime's dependency
resolution provides the actual topological scheduling, so independent
branches run concurrently without any DAG-level orchestration.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """A node in a static task graph. Immutable once constructed."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal ------------------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def _resolve_args(self, memo: Dict[int, Any], input_value) -> Tuple:
        args = [
            a._execute_impl(memo, input_value) if isinstance(a, DAGNode)
            else a
            for a in self._bound_args
        ]
        kwargs = {
            k: (v._execute_impl(memo, input_value) if isinstance(v, DAGNode)
                else v)
            for k, v in self._bound_kwargs.items()
        }
        return args, kwargs

    # -- execution ------------------------------------------------------------
    def execute(self, *input_args, **input_kwargs):
        """Run the whole graph once; returns ObjectRef(s) for this node.

        ``input_args``/``input_kwargs`` feed the graph's InputNode (one
        positional value, or several accessed via InputAttributeNode).
        """
        if len(input_args) == 1 and not input_kwargs:
            input_value = input_args[0]
        elif not input_args and not input_kwargs:
            input_value = None
        else:
            input_value = _DAGInput(input_args, input_kwargs)
        memo: Dict[int, Any] = {}
        return self._execute_impl(memo, input_value)

    def _execute_impl(self, memo: Dict[int, Any], input_value):
        key = id(self)
        if key not in memo:
            memo[key] = self._submit(memo, input_value)
        return memo[key]

    def _submit(self, memo, input_value):
        raise NotImplementedError


class _DAGInput:
    """Multi-arg input bundle, unpacked by InputAttributeNode."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self.args = args
        self.kwargs = kwargs


class InputNode(DAGNode):
    """Placeholder for the value passed to ``dag.execute(value)``
    (input_node.py InputNode). Usable as a context manager, matching the
    reference's ``with InputNode() as inp:`` idiom."""

    _local = threading.local()

    def __init__(self):
        super().__init__((), {})

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name)

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)

    def _submit(self, memo, input_value):
        return input_value


class InputAttributeNode(DAGNode):
    """``inp.x`` / ``inp[0]`` — one field of a multi-arg execute() call."""

    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self._key = key

    def _submit(self, memo, input_value):
        value = self._bound_args[0]._execute_impl(memo, input_value)
        if isinstance(value, _DAGInput):
            if isinstance(self._key, int):
                return value.args[self._key]
            if self._key in value.kwargs:
                return value.kwargs[self._key]
            return value.args[self._key]
        if isinstance(self._key, int):
            return value[self._key]
        return getattr(value, self._key, value[self._key])


class FunctionNode(DAGNode):
    """``fn.bind(...)`` over a remote function (function_node.py)."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict[str, Any],
                 options: Optional[dict] = None):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn
        self._options = options or {}

    def options(self, **opts) -> "FunctionNode":
        return FunctionNode(self._remote_fn, self._bound_args,
                            self._bound_kwargs, {**self._options, **opts})

    def _submit(self, memo, input_value):
        args, kwargs = self._resolve_args(memo, input_value)
        fn = self._remote_fn
        if self._options:
            fn = fn.options(**self._options)
        return fn.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    """``actor.method.bind(...)`` over a live actor handle
    (class_node.py ClassMethodNode)."""

    def __init__(self, actor_method, args: Tuple, kwargs: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._method = actor_method

    def _submit(self, memo, input_value):
        args, kwargs = self._resolve_args(memo, input_value)
        return self._method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundle several leaves as the DAG output (output_node.py):
    ``MultiOutputNode([a, b]).execute(x)`` -> [ref_a, ref_b]."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _submit(self, memo, input_value):
        return [n._execute_impl(memo, input_value)
                for n in self._bound_args]
