"""Positive and near-miss sources for every graftlint rule of the port
(the counterpart of ``tests/resources/graftlint/`` for
``bigdl_tpu/analysis``), in the port's idiom.

``FIXTURES[code]`` is ``(positive, near_miss)``: source texts the
analyser must flag with ``code`` (the positive) and leave silent for
``code`` (the near-miss). The capture rules' pairs (``RUNNABLE``) are
programs too: each defines ``run(device)``, which drives the hazard
through ``GraphedProgram`` on a CUDA device with tiny tensors and returns
what it saw — ``hazard`` (the positive's hazard showed: the capture
raised, the side effect counted the capture only, the capture refused
the unregistered generator's draw or two replays drew equal numbers, a
held output equals the next replay's, one capture a length, the
``data_ptr`` error), ``captured`` and ``equal_to_eager``
(the near-miss captured and its replays equal its eager body), and a
``detail`` line. ``chip_smoke.py`` phase 3r lints and runs them on the
card; on the CPU they are only linted (``tests/test_torch_graftlint_*``).
"""

from __future__ import annotations

from typing import Dict, Tuple

_HEAD = """import torch
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram
"""

# --------------------------------------------------------------- JG001
JG001_FIRE = _HEAD + '''

def run(device):
    x = torch.arange(4.0, device=device)
    out = torch.zeros(4, device=device)

    def body():
        scale = float(x.sum())        # a host read under the capture
        out.copy_(x * scale)
        return out

    prog = GraphedProgram(body, device)
    try:
        prog()
        prog()
    except RuntimeError as e:
        return {"hazard": True, "detail": "capture raised: %s" % str(e)[:90]}
    return {"hazard": False, "detail": "captured a host read"}
'''

JG001_OK = _HEAD + '''

def run(device):
    x = torch.arange(4.0, device=device)
    out = torch.zeros(4, device=device)

    def body():
        scale = x.sum()               # stays on the card
        out.copy_(x * scale)
        return out

    prog = GraphedProgram(body, device)
    prog()
    replays = [prog().clone() for _ in range(2)]
    eager = x * x.sum()
    return {"hazard": False, "captured": True,
            "equal_to_eager": all(torch.equal(r, eager) for r in replays),
            "detail": "2 replays against the eager body"}
'''

# --------------------------------------------------------------- JG002
JG002_FIRE = _HEAD + '''

def run(device):
    x = torch.ones(4, device=device)
    calls = {"body": 0}

    def body():
        calls["body"] += 1            # counts the capture, not the replays
        return x * 2

    prog = GraphedProgram(body, device)
    for _ in range(5):
        prog()
    torch.cuda.synchronize(device)
    return {"hazard": calls["body"] < 5,
            "detail": "5 calls, the body's counter read %d" % calls["body"]}
'''

JG002_OK = _HEAD + '''

def run(device):
    x = torch.ones(4, device=device)
    calls = {"program": 0}

    def body():
        return x * 2

    prog = GraphedProgram(body, device)
    outs = []
    for _ in range(5):
        outs.append(prog().clone())
        calls["program"] += 1         # counted by the replay's caller
    return {"hazard": False, "captured": True,
            "equal_to_eager": calls["program"] == 5 and all(
                torch.equal(o, x * 2) for o in outs),
            "detail": "5 calls counted %d" % calls["program"]}
'''

# --------------------------------------------------------------- JG003
JG003_FIRE = _HEAD + '''

def run(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    out = torch.zeros(4, device=device)

    def body():
        out.copy_(torch.rand(4, device=device, generator=gen))
        return out

    prog = GraphedProgram(body, device)    # gen is not given to the graph
    try:
        prog()
        a = prog().clone()
        b = prog().clone()
    except RuntimeError as e:
        return {"hazard": True, "detail": "capture raised: %s" % str(e)[:90]}
    return {"hazard": bool(torch.equal(a, b)),
            "detail": "two replays bit-equal: %s" % bool(torch.equal(a, b))}
'''

JG003_OK = _HEAD + '''

def run(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    out = torch.zeros(4, device=device)

    def body():
        out.copy_(torch.rand(4, device=device, generator=gen))
        return out

    prog = GraphedProgram(body, device, generators=lambda: [gen])
    prog()
    replays = [prog().clone() for _ in range(2)]
    ref = torch.Generator(device=device)
    ref.manual_seed(5)
    stream = [torch.rand(4, device=device, generator=ref) for _ in range(6)]
    at = [i for i in range(5) if torch.equal(stream[i], replays[0])
          and torch.equal(stream[i + 1], replays[1])]
    return {"hazard": False, "captured": True, "equal_to_eager": bool(at),
            "detail": "replays are draws %s of the eager stream"
                      % ([at[0] + 1, at[0] + 2] if at else None)}
'''

# --------------------------------------------------------------- JG006
JG006_FIRE = _HEAD + '''

def run(device):
    x = torch.arange(4.0, device=device)
    out = torch.zeros(4, device=device)

    def body():
        if x.sum() > 0:               # a branch on a tensor
            out.copy_(x * 2)
        else:
            out.copy_(x * 3)
        return out

    prog = GraphedProgram(body, device)
    try:
        prog()
        prog()
    except RuntimeError as e:
        return {"hazard": True, "detail": "capture raised: %s" % str(e)[:90]}
    return {"hazard": False, "detail": "captured a tensor branch"}
'''

JG006_OK = _HEAD + '''

def run(device):
    x = torch.arange(4.0, device=device)
    out = torch.zeros(4, device=device)

    def body():
        out.copy_(torch.where(x.sum() > 0, x * 2, x * 3))
        return out

    prog = GraphedProgram(body, device)
    prog()
    replays = [prog().clone() for _ in range(2)]
    eager = torch.where(x.sum() > 0, x * 2, x * 3)
    return {"hazard": False, "captured": True,
            "equal_to_eager": all(torch.equal(r, eager) for r in replays),
            "detail": "2 replays against the eager body"}
'''

# --------------------------------------------------------------- JG007
JG007_FIRE = _HEAD + '''

def run(device):
    x = torch.zeros(4, device=device)
    prog = GraphedProgram(lambda: x * 2, device)
    prog()
    x.fill_(1.0)
    held = prog()                     # the graph's static output
    x.fill_(2.0)
    newer = prog()                    # this replay overwrites it
    seen = held.clone()
    return {"hazard": bool(torch.equal(seen, newer)),
            "detail": "held output reads %.1f after the next replay "
                      "(2.0 when taken)" % float(seen[0])}
'''

JG007_OK = _HEAD + '''

def run(device):
    x = torch.zeros(4, device=device)
    prog = GraphedProgram(lambda: x * 2, device)
    prog()
    x.fill_(1.0)
    held = prog().clone()             # copied before the next replay
    x.fill_(2.0)
    newer = prog().clone()
    return {"hazard": False, "captured": True,
            "equal_to_eager": bool(torch.equal(held, torch.full_like(
                x, 2.0)) and torch.equal(newer, x * 2)),
            "detail": "held %.1f, next %.1f" % (float(held[0]),
                                                float(newer[0]))}
'''

# --------------------------------------------------------- JG013/JG019
JG013_FIRE = _HEAD + '''from bigdl_tpu_torch.telemetry.profiling import tracked_jit

LENGTHS = (3, 5, 7, 9, 11, 12)


def build(buf, device):
    return GraphedProgram(lambda: buf * 2, device)


def run(device):
    programs, buffers = {}, {}
    family = tracked_jit(lambda t: t * 2, site="graftlint.fixture.fire")
    for req in [list(range(n)) for n in LENGTHS]:
        n = len(req)
        if n not in programs:
            buf = torch.zeros(n, device=device)
            buffers[n] = buf
            programs[n] = build(buf, device)
        buffers[n].fill_(1.0)
        programs[n]()
        family(torch.zeros(n, device=device))
    for prog in programs.values():
        prog.close()
    return {"hazard": len(programs) == len(set(LENGTHS)),
            "captures": len(programs), "compiles": family.compiles,
            "detail": "%d lengths made %d captures and %d compiles"
                      % (len(LENGTHS), len(programs), family.compiles)}
'''

JG013_OK = _HEAD + '''from bigdl_tpu_torch.telemetry.profiling import tracked_jit

LENGTHS = (3, 5, 7, 9, 11, 12)


def bucket(n):
    b = 4
    while b < n:
        b *= 2
    return b


def build(buf, device):
    return GraphedProgram(lambda: buf * 2, device)


def run(device):
    programs, buffers = {}, {}
    family = tracked_jit(lambda t: t * 2, site="graftlint.fixture.ok")
    outs = []
    for req in [list(range(n)) for n in LENGTHS]:
        b = bucket(len(req))
        if b not in programs:
            buf = torch.zeros(b, device=device)
            buffers[b] = buf
            programs[b] = build(buf, device)
        buffers[b].fill_(1.0)
        outs.append(programs[b]().clone())
        family(torch.zeros(b, device=device))
    buckets = len({bucket(n) for n in LENGTHS})
    for prog in programs.values():
        prog.close()
    return {"hazard": False, "captured": len(programs) == buckets,
            "captures": len(programs), "compiles": family.compiles,
            "equal_to_eager": family.compiles == buckets and all(
                torch.equal(o, torch.full_like(o, 2.0)) for o in outs),
            "detail": "%d lengths made %d captures and %d compiles "
                      "(%d buckets)" % (len(LENGTHS), len(programs),
                                        family.compiles, buckets)}
'''

# --------------------------------------------------------------- JG020
JG020_FIRE = _HEAD + '''

def run(device):
    x = torch.zeros(4, device=device)
    prog = GraphedProgram(lambda: x * 2, device, inputs=lambda: [x])
    prog()
    prog()
    x = torch.ones(4, device=device)  # rebound: the graph reads the old x
    try:
        prog()
    except RuntimeError as e:
        return {"hazard": "data_ptr" in str(e),
                "detail": "replay raised: %s" % str(e)[:90]}
    return {"hazard": False, "detail": "replayed over a rebound input"}
'''

JG020_OK = _HEAD + '''

def run(device):
    x = torch.zeros(4, device=device)
    prog = GraphedProgram(lambda: x * 2, device, inputs=lambda: [x])
    prog()
    prog()
    x.copy_(torch.ones(4, device=device))  # copied into: same address
    out = prog().clone()
    return {"hazard": False, "captured": True,
            "equal_to_eager": bool(torch.equal(out, x * 2)),
            "detail": "replay %.1f, eager %.1f" % (float(out[0]),
                                                   float((x * 2)[0]))}
'''

# ----------------------------------------------------- lint-only pairs
JG004_FIRE = '''import torch
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram


def serve(batches, device):
    outs = []
    for x in batches:
        prog = GraphedProgram(lambda: x * 2, device)   # a capture per batch
        outs.append(prog())
    return outs
'''

JG004_OK = '''import torch
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram


def serve(batches, device):
    static = torch.zeros(4, device=device)
    prog = GraphedProgram(lambda: static * 2, device)  # built once
    outs = []
    for x in batches:
        static.copy_(x)
        outs.append(prog().clone())
    return outs
'''

JG005_FIRE = '''from bigdl_tpu_torch.telemetry.profiling import tracked_jit
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram


def step(params, batch):
    return params, batch


def body(x):
    return x * 2


step_t = tracked_jit(step, site="fixture.step", donate_argnums=(2,))
tiny_t = tracked_jit(step, site="fixture.tiny", cache_size=0)
prog = GraphedProgram(body, "cuda")
'''

JG005_OK = '''from bigdl_tpu_torch.telemetry.profiling import tracked_jit
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram


def step(params, batch):
    return params, batch


def body():
    return None


step_t = tracked_jit(step, site="fixture.step", donate_argnums=(0,))
tiny_t = tracked_jit(step, site="fixture.tiny", cache_size=8)
prog = GraphedProgram(body, "cuda")
'''

JG008_FIRE = '''def build(layers=[], options=dict(momentum=0.9)):
    return layers, options
'''

JG008_OK = '''def build(layers=None, options=None):
    return list(layers or ()), dict(options or {})
'''

JG010_FIRE = '''from bigdl_tpu_torch.parallel.mesh import MeshTopology


def specs(model):
    return {"w": ("tensr", None)}          # no axis of mesh.py


def shard(module, full):
    topo = MeshTopology(data=2)
    param_specs = {}
    param_specs["w"] = ("tensor", None)    # the topology has no tensor axis
    return topo, param_specs
'''

JG010_OK = '''from bigdl_tpu_torch.parallel.mesh import MeshTopology


def specs(model):
    return {"w": ("tensor", None), "b": ()}


def shard(module, full):
    topo = MeshTopology(data=2, tensor=2)
    param_specs = {}
    param_specs["w"] = ("tensor", None)
    return topo, param_specs
'''

JG011_FIRE = '''import torch


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x.clone(), axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None                     # forward took three inputs


def reduce(x, mesh, axis="tensor"):
    return _Reduce.apply(x, mesh, axis)
'''

JG011_OK = '''import torch


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x.clone(), axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce(x, mesh, axis="tensor"):
    return _Reduce.apply(x, mesh, axis)
'''

JG012_FIRE = '''from bigdl_tpu_torch.parallel.mesh import MeshTopology


def sync(grad):
    mesh = MeshTopology(data=2).build()
    mesh.all_reduce(grad, axis="tensor")   # the topology has no tensor axis
    mesh.all_gather(grad, "sequence")      # no axis of mesh.py
    return grad
'''

JG012_OK = '''from bigdl_tpu_torch.parallel.mesh import MeshTopology


def sync(grad):
    mesh = MeshTopology(data=2, tensor=2).build()
    mesh.all_reduce(grad, axis="tensor")
    mesh.all_gather(grad, "data")
    mesh.all_reduce(grad, axis="world")
    return grad
'''

JG014_FIRE = '''from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram


class Worker:
    def __init__(self, device):
        self.device = device
        self._graphs = {}

    def _program(self, shape, body):
        prog = self._graphs.get(shape)
        if prog is None:
            prog = GraphedProgram(body, self.device)
            # graftlint: ignore[JG013] -- shape-keyed family (fixture: JG014 only)
            self._graphs[shape] = prog
        return prog

    def run(self, requests, body):
        while requests:
            self._program(len(requests.pop()), body)()
'''

JG014_OK = '''from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram

_CAP = 8


class Worker:
    def __init__(self, device):
        self.device = device
        self._graphs = {}

    def _program(self, shape, body):
        prog = self._graphs.get(shape)
        if prog is None:
            if len(self._graphs) >= _CAP:
                self.release()
            prog = GraphedProgram(body, self.device)
            # graftlint: ignore[JG013] -- shape-keyed family bounded at _CAP (fixture)
            self._graphs[shape] = prog
        return prog

    def release(self):
        graphs, self._graphs = self._graphs, {}
        for prog in graphs.values():
            prog.close()

    def run(self, requests, body):
        while requests:
            self._program(len(requests.pop()), body)()
'''

JG015_FIRE = '''import threading


class Server:
    def __init__(self):
        self._queue = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            with self._lock:
                if self._queue:
                    self._queue.pop(0)

    def submit(self, item):
        self._queue.append(item)           # no lock on the client side
'''

JG015_OK = '''import threading


class Server:
    def __init__(self):
        self._queue = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            with self._lock:
                if self._queue:
                    self._queue.pop(0)

    def submit(self, item):
        with self._lock:
            self._queue.append(item)
'''

JG016_FIRE = '''import threading

_a = threading.Lock()
_b = threading.Lock()


def one():
    with _a:
        with _b:
            return 1


def two():
    with _b:
        with _a:
            return 2
'''

JG016_OK = '''import threading

_a = threading.Lock()
_b = threading.Lock()


def one():
    with _a:
        with _b:
            return 1


def two():
    with _a:
        with _b:
            return 2
'''

JG017_FIRE = '''import threading

import torch


class Meter:
    def __init__(self):
        self._lock = threading.Lock()
        self._loss = torch.zeros(())

    def read(self):
        with self._lock:
            torch.cuda.synchronize()
            return self._loss.item()       # a device read under the lock
'''

JG017_OK = '''import threading

import torch


class Meter:
    def __init__(self):
        self._lock = threading.Lock()
        self._loss = torch.zeros(())

    def read(self):
        with self._lock:
            loss = self._loss.clone()      # the handle under the lock
        return loss.item()                 # the read outside it
'''

JG018_FIRE = '''import torch

from bigdl_tpu_torch.parallel.mesh import MeshTopology
from bigdl_tpu_torch.parallel.tensor_parallel import shard_leaf, split


def leaf(module):
    full = torch.zeros(10, 16)
    return shard_leaf(module, "weight", full, ("tensor", None), 4, 0)


def blocks():
    mesh = MeshTopology(sequence=4).build()
    x = torch.zeros(2, 6, 16)
    return split(x, mesh, "seq", 1)
'''

JG018_OK = '''import torch

from bigdl_tpu_torch.parallel.mesh import MeshTopology
from bigdl_tpu_torch.parallel.tensor_parallel import shard_leaf, split


def leaf(module):
    full = torch.zeros(12, 16)
    return shard_leaf(module, "weight", full, ("tensor", None), 4, 0)


def blocks():
    mesh = MeshTopology(sequence=4).build()
    x = torch.zeros(2, 8, 16)
    return split(x, mesh, "seq", 1)
'''

JG019_FIRE = JG013_FIRE
JG019_OK = JG013_OK

FIXTURES: Dict[str, Tuple[str, str]] = {
    "JG001": (JG001_FIRE, JG001_OK), "JG002": (JG002_FIRE, JG002_OK),
    "JG003": (JG003_FIRE, JG003_OK), "JG004": (JG004_FIRE, JG004_OK),
    "JG005": (JG005_FIRE, JG005_OK), "JG006": (JG006_FIRE, JG006_OK),
    "JG007": (JG007_FIRE, JG007_OK), "JG008": (JG008_FIRE, JG008_OK),
    "JG010": (JG010_FIRE, JG010_OK), "JG011": (JG011_FIRE, JG011_OK),
    "JG012": (JG012_FIRE, JG012_OK), "JG013": (JG013_FIRE, JG013_OK),
    "JG014": (JG014_FIRE, JG014_OK), "JG015": (JG015_FIRE, JG015_OK),
    "JG016": (JG016_FIRE, JG016_OK), "JG017": (JG017_FIRE, JG017_OK),
    "JG018": (JG018_FIRE, JG018_OK), "JG019": (JG019_FIRE, JG019_OK),
    "JG020": (JG020_FIRE, JG020_OK),
}

#: the capture rules' runnable pairs, by the codes each row holds
RUNNABLE: Dict[str, Tuple[str, ...]] = {
    "JG001": ("JG001",), "JG002": ("JG002",), "JG003": ("JG003",),
    "JG006": ("JG006",), "JG007": ("JG007",),
    "JG013/JG019": ("JG013", "JG019"), "JG020": ("JG020",),
}


def pair(row: str) -> Tuple[str, str]:
    """A runnable row's (positive, near-miss) sources."""
    return FIXTURES[RUNNABLE[row][0]]
