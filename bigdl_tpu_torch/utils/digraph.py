"""General directed-graph utility (counterpart of
``bigdl_tpu/utils/digraph.py``; reference ``utils/DirectedGraph.scala:33``
and its ``Node`` at ``:120``): Kahn topological sort with cycle check, DFS,
BFS, and the ``>>`` edge builder (Scala's ``->``). ``nn.Graph`` keeps its
own module-graph walk; this is the standalone structure for user code.
Pure Python, so the orders equal the reference's node for node.
"""

from __future__ import annotations

from typing import Any, Iterator, List


class Node:
    """A graph node holding an ``element`` with directed edges
    (reference ``DirectedGraph.scala:120``)."""

    def __init__(self, element: Any):
        self.element = element
        self.prevs: List["Node"] = []
        self.nexts: List["Node"] = []

    def __rshift__(self, other: "Node") -> "Node":
        """``a >> b`` adds the edge a->b and returns ``b`` for chaining
        (Scala's ``a -> b``)."""
        self.nexts.append(other)
        other.prevs.append(self)
        return other

    add = __rshift__

    def __repr__(self):
        return f"Node({self.element!r})"


class DirectedGraph:
    """Graph rooted at ``source``; ``reverse=True`` walks edges backwards
    (the reference builds its module graph reversed from a dummy output)."""

    def __init__(self, source: Node, reverse: bool = False):
        self.source = source
        self.reverse = reverse

    def _adj(self, node: Node) -> List[Node]:
        return node.prevs if self.reverse else node.nexts

    def size(self) -> int:
        return sum(1 for _ in self.bfs())

    def edges(self) -> int:
        return sum(len(self._adj(n)) for n in self.bfs())

    def bfs(self) -> Iterator[Node]:
        """Breadth-first traversal from the source."""
        from collections import deque
        seen = {id(self.source)}
        q = deque([self.source])
        while q:
            n = q.popleft()
            yield n
            for s in self._adj(n):
                if id(s) not in seen:
                    seen.add(id(s))
                    q.append(s)

    def dfs(self) -> Iterator[Node]:
        """Depth-first traversal from the source."""
        seen = set()
        stack = [self.source]
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            yield n
            stack.extend(self._adj(n))

    def topology_sort(self) -> List[Node]:
        """Kahn's algorithm over the reachable subgraph; raises on cycles
        (reference ``DirectedGraph.topologySort``)."""
        nodes = list(self.bfs())
        ids = {id(n) for n in nodes}
        indegree = {id(n): 0 for n in nodes}
        for n in nodes:
            for s in self._adj(n):
                if id(s) in ids:
                    indegree[id(s)] += 1
        ready = [n for n in nodes if indegree[id(n)] == 0]
        order: List[Node] = []
        while ready:
            n = ready.pop()
            order.append(n)
            for s in self._adj(n):
                indegree[id(s)] -= 1
                if indegree[id(s)] == 0:
                    ready.append(s)
        if len(order) != len(nodes):
            raise ValueError("graph contains a cycle")
        return order
