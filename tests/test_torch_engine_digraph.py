"""``utils/digraph.py`` and ``utils/engine.py`` of the port against the
reference's on the CPU: ``DirectedGraph``'s orders equal the reference's on
seeded random DAGs; ``Engine``'s topology, ``io_pool``,
``check_singleton`` and ``default_mesh`` refusing, citing ROADMAP A.4.
"""

import os

import numpy as np
import pytest
import torch

import bigdl_tpu_torch
from bigdl_tpu.utils.digraph import DirectedGraph as RefGraph
from bigdl_tpu.utils.digraph import Node as RefNode
from bigdl_tpu_torch import utils
from bigdl_tpu_torch.utils import DiGraphNode, DirectedGraph, Engine


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def engine():
    Engine.reset()
    yield Engine
    Engine.reset()


def _dag(node_cls, seed: int, n: int = 24, p: float = 0.2):
    """A seeded random DAG over n nodes (edges i -> j for i < j) with one
    source reaching every node."""
    rng = np.random.default_rng(seed)
    nodes = [node_cls(i) for i in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < p:
                nodes[i] >> nodes[j]
    for j in range(1, n):
        if not nodes[j].prevs:
            nodes[0] >> nodes[j]
    return nodes


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("reverse", [False, True])
def test_orders_equal_the_reference(seed, reverse):
    ours, ref = _dag(DiGraphNode, seed), _dag(RefNode, seed)
    src = -1 if reverse else 0
    g, r = DirectedGraph(ours[src], reverse), RefGraph(ref[src], reverse)
    elems = lambda it: [n.element for n in it]
    assert elems(g.bfs()) == elems(r.bfs())
    assert elems(g.dfs()) == elems(r.dfs())
    assert elems(g.topology_sort()) == elems(r.topology_sort())
    assert (g.size(), g.edges()) == (r.size(), r.edges())
    order = {n.element: i for i, n in enumerate(g.topology_sort())}
    for n in ours:
        for s in (n.prevs if reverse else n.nexts):
            if n.element in order:
                assert order[n.element] < order[s.element]


def test_cycle_raises_and_exports():
    a, b, c = DiGraphNode("a"), DiGraphNode("b"), DiGraphNode("c")
    a >> b >> c >> a
    with pytest.raises(ValueError, match="cycle"):
        DirectedGraph(a).topology_sort()
    assert utils.DirectedGraph is DirectedGraph
    assert bigdl_tpu_torch.Engine is Engine is utils.Engine


def test_engine_topology_on_the_cpu(engine, monkeypatch):
    from bigdl_tpu_torch import native
    threads = []
    monkeypatch.setattr(native, "set_num_threads", threads.append)
    engine.init(core_number=3, devices=["cpu"])
    assert engine.is_initialized()
    assert engine.devices() == [torch.device("cpu")]
    assert engine.device_count() == 1
    assert (engine.node_number(), engine.core_number()) == (1, 3)
    assert threads == [3]
    assert (engine.process_index(), engine.process_count()) == (0, 1)
    with pytest.raises(NotImplementedError, match=r"A\.4 \(distributed"):
        engine.default_mesh()


def test_engine_without_a_card_raises(engine):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.local_devices()


def test_io_pool_and_env_check(engine, monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_DISABLE_ENV_CHECK", raising=False)
    monkeypatch.setenv("BIGDL_TPU_IO_THREADS", "3")
    engine.init(devices=["cpu"])
    pool = engine.io_pool()
    assert pool is engine.io_pool() and pool._max_workers == 3
    assert pool.submit(lambda: 41 + 1).result(timeout=10) == 42
    monkeypatch.setenv("OMP_NUM_THREADS", "16")
    assert any("OMP_NUM_THREADS=16" in p for p in engine.check_env())
    with pytest.raises(RuntimeError, match="launch environment"):
        engine.check_env(strict=True)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert engine.check_env(strict=True) == []
    monkeypatch.setenv("BIGDL_TPU_DISABLE_ENV_CHECK", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "64")
    assert engine.check_env(strict=True) == []


def test_check_singleton(engine, monkeypatch, tmp_path):
    monkeypatch.delenv("BIGDL_CHECK_SINGLETON", raising=False)
    assert engine.check_singleton()              # off by default
    monkeypatch.setenv("BIGDL_CHECK_SINGLETON", "1")
    monkeypatch.setenv("BIGDL_SINGLETON_DIR", str(tmp_path))
    lock = tmp_path / "bigdl_tpu.singleton.lock"
    assert engine.check_singleton() and lock.read_text() == str(os.getpid())
    assert engine.check_singleton()              # held by this process
    lock.write_text("1")                          # a live process (init)
    assert not engine.check_singleton()
    lock.write_text(str(2 ** 22 + 12345))         # a pid no process has
    assert engine.check_singleton() and lock.read_text() == str(os.getpid())
    lock.write_text("")                           # unreadable: not taken
    assert not engine.check_singleton()
