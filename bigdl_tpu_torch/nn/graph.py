"""Static DAG container (counterpart of ``bigdl_tpu/nn/graph.py``: ``Node``,
``Input``, ``Module.inputs`` and ``Graph`` are ported).

Built as the reference builds it:

    inp = Input().inputs()
    h = Linear(10, 20).inputs(inp)
    out = Linear(20, 2).inputs(ReLU().inputs(h))
    model = Graph(inp, out)

The topological order is computed once, at construction, with the
reference's exact tie-breaking: a depth-first walk from the outputs, then
Kahn's algorithm popping the last ready node. Each node's module is a
child named ``n{i}_{module.name}`` in that order, so the names, and with
them ``export_tree_state``/``import_tree_state``, match a reference Graph
built the same way. ``forward`` walks the order; autograd sums the
gradients of a fan-out.

The port has no ``Table`` activity: a Graph of several inputs takes them
as a tuple or list, a node of several predecessors receives their outputs
as a tuple, and a Graph of several outputs returns a tuple.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

from bigdl_tpu_torch.nn.containers import Container
from bigdl_tpu_torch.nn.module import Module


class Node:
    """A graph node wrapping a module (reference ``Node``)."""

    _counter = 0

    def __init__(self, module: Module):
        self.module = module
        self.prev: List["Node"] = []
        Node._counter += 1
        self.id = Node._counter

    def __repr__(self):
        return f"Node({self.module.name}#{self.id})"


def _as_list(x) -> List:
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Input(Module):
    """Graph input placeholder (reference ``Input``)."""

    def forward(self, input):
        return input

    def inputs(self, *nodes) -> Node:
        if nodes:
            raise ValueError("Input takes no predecessors")
        return Node(self)


def _inputs(self: Module, *nodes: Node) -> Node:
    """``module.inputs(n1, n2, ...)``: a Node of this module after the
    given nodes (reference ``AbstractModule.inputs``)."""
    n = Node(self)
    n.prev = list(nodes)
    return n


Module.inputs = _inputs   # the graph-building verb on every module


class Graph(Container):
    """DAG container (reference ``Graph``)."""

    def __init__(self, input: Union[Node, Sequence[Node]],
                 output: Union[Node, Sequence[Node]]):
        super().__init__()
        self.input_nodes = _as_list(input)
        self.output_nodes = _as_list(output)
        self._sorted = self._topo_sort()
        for i, node in enumerate(self._sorted):
            self.add_module(f"n{i}_{node.module.name}", node.module)

    def _topo_sort(self) -> List[Node]:
        # the reference's order, tie for tie: the child names derive from
        # it, so it is part of the checkpoint format
        nodes: List[Node] = []
        seen: Dict[int, Node] = {}
        stack = list(self.output_nodes)
        while stack:
            n = stack.pop()
            if n.id in seen:
                continue
            seen[n.id] = n
            nodes.append(n)
            stack.extend(n.prev)
        indegree = {n.id: len(n.prev) for n in nodes}
        succ: Dict[int, List[Node]] = {n.id: [] for n in nodes}
        for n in nodes:
            for p in n.prev:
                succ[p.id].append(n)
        ready = [n for n in nodes if indegree[n.id] == 0]
        order: List[Node] = []
        while ready:
            n = ready.pop()
            order.append(n)
            for s in succ[n.id]:
                indegree[s.id] -= 1
                if indegree[s.id] == 0:
                    ready.append(s)
        if len(order) != len(nodes):
            raise ValueError("Graph contains a cycle")
        for n in self.input_nodes:
            if n.id not in seen:
                raise ValueError("An input node is not connected to any output")
        return order

    def forward(self, input):
        values: Dict[int, object] = {}
        ins = _as_list(input)
        if len(ins) != len(self.input_nodes):
            raise ValueError(f"Graph expects {len(self.input_nodes)} inputs, "
                             f"got {len(ins)}")
        for node, x in zip(self.input_nodes, ins):
            values[node.id] = node.module(x)
        for node in self._sorted:
            if node.id in values:
                continue
            args = [values[p.id] for p in node.prev]
            values[node.id] = node.module(args[0] if len(args) == 1
                                          else tuple(args))
        outs = [values[n.id] for n in self.output_nodes]
        return outs[0] if len(outs) == 1 else tuple(outs)
