"""Static task graphs (the ``ray.dag`` analog).

The reference builds lazy DAGs of tasks/actor calls with ``.bind()``
(python/ray/dag/dag_node.py:23; function/class/method nodes in
function_node.py, class_node.py) and executes them with ``dag.execute()``;
Serve deployment graphs compile onto it. Here the same surface:

    @rmt.remote
    def add(a, b): return a + b

    with InputNode() as inp:
        dag = add.bind(inp, add.bind(inp, 1))
    assert rmt.get(dag.execute(2)) == 5

Nodes are immutable descriptions; ``execute`` walks the graph bottom-up,
memoizing each node into ONE task submission per execution (diamond
dependencies execute once) and wiring parent results as ObjectRefs so the
scheduler overlaps independent branches.
"""

from .dag_node import (  # noqa: F401
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "DAGNode",
    "FunctionNode",
    "ClassMethodNode",
    "InputNode",
    "InputAttributeNode",
    "MultiOutputNode",
]
