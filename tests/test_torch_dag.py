"""The DAG library (``dag/``) in both packages.

No test of the JAX package exercises ``dag``. Here its module
docstring's example runs in both: the graph ``add(inp, add(inp, 1))``
gives 5 for the input 2. The docstring builds it with ``add.bind(...)``;
the JAX package's remote functions have no ``bind`` (a fault of the
reference: the example raises there), so on the JAX side the same graph
is built from ``FunctionNode``s. The port's remote functions and actor
methods ``bind`` into ``FunctionNode`` and ``ClassMethodNode``.
"""

import pytest

import ray_memory_management_tpu as jrmt
import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu.dag import FunctionNode as JFunctionNode
from ray_memory_management_tpu.dag import InputNode as JInputNode
from ray_memory_management_tpu_torch.dag import (
    ClassMethodNode, FunctionNode, InputNode, MultiOutputNode,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401


def test_docstring_example_gives_5_in_both_packages(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    jrmt.init(num_cpus=2)
    try:
        @jrmt.remote
        def jadd(a, b):
            return a + b

        with pytest.raises(AttributeError):
            jadd.bind
        with JInputNode() as inp:
            jdag = JFunctionNode(jadd, (inp, JFunctionNode(jadd, (inp, 1),
                                                           {})), {})
        want = jrmt.get(jdag.execute(2))
    finally:
        jrmt.shutdown()

    rmt.init(num_cpus=2)
    try:
        @rmt.remote
        def add(a, b):
            return a + b

        with InputNode() as inp:
            dag = add.bind(inp, add.bind(inp, 1))
        assert isinstance(dag, FunctionNode)
        got = rmt.get(dag.execute(2))
    finally:
        rmt.shutdown()
    assert got == want == 5


def test_bind_over_actor_methods_and_multiple_outputs(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rmt.init(num_cpus=2)
    try:
        @rmt.remote
        def add(a, b):
            return a + b

        @rmt.remote
        class Scale:
            def __init__(self, k):
                self.k = k

            def apply(self, x):
                return self.k * x

        actor = Scale.remote(3)
        with InputNode() as inp:
            shared = add.bind(inp.x, inp.y)
            scaled = actor.apply.bind(shared)
            dag = MultiOutputNode([shared, scaled])
        assert isinstance(scaled, ClassMethodNode)
        assert rmt.get(dag.execute(x=2, y=5)) == [7, 21]
    finally:
        rmt.shutdown()
