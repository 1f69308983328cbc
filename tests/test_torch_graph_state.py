"""The state a CUDA graph of the serving engine's decode round reads, and the
graph helper's bookkeeping, on the CPU.

A replayed graph reads and writes fixed addresses, so the engine keeps its
round state in place: ``decode_pos`` of every attention module and the
server's ``_last_tok`` keep their ``data_ptr`` across a decode block, a
speculative round, an admission's insert and a prefill swap. The round's
eager body, which a card captures, gives the reference server's answers
(``tests/test_torch_serving.py``'s tiny model and tolerances: greedy tokens
identical). ``GraphedProgram`` refuses a CPU device, and its replay
accounting (launch counts, the moved-buffer check) is driven here through
a stand-in graph.
"""

import threading

import pytest
import torch

from bigdl_tpu.models.serving import ContinuousLMServer as JaxServer
from bigdl_tpu_torch.models.serving import ContinuousLMServer, _Request
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram
from test_torch_serving import (MAX_NEW, SERVER, _jax_model, _port_model,
                                _prompt)

PROMPTS = [_prompt(n, seed=3) for n in (5, 9)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _idle(server):
    """The server with its worker stopped, for driving its rounds from the
    test's thread."""
    server._stop.set()
    server._worker.join(timeout=30)
    assert not server._worker.is_alive()
    return server


def _state(server):
    """(id, data_ptr) of every tensor a round's graph reads."""
    return [(id(t), t.data_ptr()) for t in server._graph_inputs()]


def _positions(server):
    return [m.decode_pos for m in server._pipeline.mhas]


def test_round_state_keeps_its_addresses():
    server = _idle(ContinuousLMServer(_port_model(), device="cpu", **SERVER))
    try:
        before = _state(server)
        pos = _positions(server)
        with torch.inference_mode():
            assert server._admit(_Request(PROMPTS[0], MAX_NEW))
            assert _state(server) == before
            slot = next(iter(server._active))
            plen = len(PROMPTS[0])
            assert [int(p[slot]) for p in pos] == [plen] * len(pos)
            server._step()
            assert _state(server) == before
            assert all(a is b for a, b in zip(_positions(server), pos))
            assert [int(p[slot]) for p in pos] == [
                plen + SERVER["decode_block"]] * len(pos)
            server._pipeline.run(PROMPTS[1])   # the prefill swap
            assert _state(server) == before
    finally:
        server.close()
    assert server._graphs == {}   # the CPU runs the body, never a graph


def test_speculative_round_keeps_its_addresses_and_rolls_back_in_place():
    server = _idle(ContinuousLMServer(
        _port_model(), device="cpu", draft=_port_model(), spec_len=3,
        **SERVER))
    try:
        before = _state(server)
        pos = _positions(server)
        d_pos = [m.decode_pos for m in server._d_pipeline.mhas]
        with torch.inference_mode():
            assert server._admit(_Request(PROMPTS[1], MAX_NEW))
            slot = next(iter(server._active))
            toks, counts = server._spec()
        assert _state(server) == before
        # an identical draft is accepted whole: both models end spec_len + 1
        # past the prompt, in the tensors they started with
        assert counts[slot] == 4
        want = len(PROMPTS[1]) + 4
        assert [int(p[slot]) for p in pos + d_pos] == [want] * (2 * len(pos))
        assert int(server._last_tok[slot]) == toks[slot][3]
    finally:
        server.close()


def test_round_body_gives_the_reference_answers():
    """The eager body a card captures, driven round by round, emits what
    the reference's server answers."""
    ref_server = JaxServer(_jax_model(), **SERVER)
    try:
        want = [ref_server.submit(p, MAX_NEW, timeout=300) for p in PROMPTS]
    finally:
        ref_server.close()
    server = _idle(ContinuousLMServer(_port_model(), device="cpu", **SERVER))
    try:
        with torch.inference_mode():
            for p in PROMPTS:
                assert server._admit(_Request(p, MAX_NEW))
            first = {s: list(sl.emitted) for s, sl in server._active.items()}
            toks = server._step_body().numpy()
        got = {tuple(sl.req.ids): first[s] + toks[s].tolist()
               for s, sl in server._active.items()}
        assert [got[tuple(p)][:MAX_NEW] for p in PROMPTS] == want
    finally:
        server.close()


def test_graphed_program_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        GraphedProgram(lambda: None, "cpu")


def test_launch_counter_add_counts_n():
    c = _build.LaunchCounter()
    c.add()
    c.add(5)
    assert c.value == 6
    c.reset()
    assert c.value == 0


def test_recording_diverts_only_the_capture_streams_launches(monkeypatch):
    """Launches made while the capture stream is current, from any thread,
    are recorded; those on other streams count. Streams are stood in for
    by a per-thread key (no card here)."""
    current = threading.local()
    monkeypatch.setattr(_build, "_current_stream_key",
                        lambda: getattr(current, "key", 0))
    c = _build.LaunchCounter()

    def launch(key, n):
        current.key = key
        c.add(n)

    with _build.recording_launches(7) as record:
        launch(7, 3)
        for key, n in ((7, 4), (8, 2)):   # an autograd thread; another stream
            other = threading.Thread(target=launch, args=(key, n))
            other.start()
            other.join(timeout=30)
            assert not other.is_alive()
        with pytest.raises(RuntimeError, match="already"):
            with _build.recording_launches(7):
                pass
    launch(7, 1)
    assert record == {c: 7} and c.value == 3
    assert _build._CAPTURING == {}


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def reset(self):
        pass


def test_replay_adds_the_recorded_launches_and_checks_addresses():
    c = _build.LaunchCounter()
    buf = [torch.zeros(4)]
    prog = GraphedProgram(lambda: None, "cuda", inputs=lambda: buf)
    with pytest.raises(RuntimeError, match="before capture"):
        prog.replay()
    # what a capture leaves behind: the graph, its launches, the addresses
    prog._graph, prog._launches = _StandInGraph(), {c: 85}
    prog._ptrs = prog._input_ptrs()
    prog.replay()
    prog.replay()
    assert c.value == 170 and prog._graph.replays == 2
    buf[0] = torch.zeros(4)                      # a swapped-in buffer
    with pytest.raises(RuntimeError, match="data_ptr moved"):
        prog.replay()
    assert c.value == 170
    prog.close()
    assert prog._graph is None
