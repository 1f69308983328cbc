"""The port's graftlint rules (``bigdl_tpu_torch/analysis/rules``), the
counterpart of ``tests/test_graftlint.py``'s fixture classes.

Every code has a positive source that must fire and a near-miss that must
stay silent, in the port's idiom (``bigdl_tpu_torch/analysis/fixtures.py``;
the capture rules' pairs are the programs ``chip_smoke.py`` phase 3r runs
on the card). The rules whose hazard is language-agnostic (JG008, JG015,
JG016) are held to the reference's on the same sources: equal findings in
code, line, column and end line. Cross-module facts are pinned on a small
package written per test.
"""

from pathlib import Path

import pytest

import bigdl_tpu.analysis as ref
import bigdl_tpu_torch.analysis as port
from bigdl_tpu_torch.analysis.fixtures import FIXTURES, RUNNABLE

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "tests" / "resources" / "graftlint"
ALL_CODES = [f"JG{i:03d}" for i in range(1, 9)] + \
    [f"JG{i:03d}" for i in range(10, 21)]


def _codes(src, name="fixture.py"):
    return {f.code for f in port.lint_source(name, src).findings}


@pytest.mark.parametrize("code", ALL_CODES)
def test_positive_fires(code):
    assert code in _codes(FIXTURES[code][0], f"{code.lower()}_fire.py")


@pytest.mark.parametrize("code", ALL_CODES)
def test_near_miss_is_silent(code):
    assert code not in _codes(FIXTURES[code][1], f"{code.lower()}_ok.py")


@pytest.mark.parametrize("row", sorted(RUNNABLE))
def test_runnable_pairs_flag_exactly_their_positive(row):
    """The pairs phase 3r runs on the card: the positive carries every
    code of its row, the near-miss none of them (nor anything else)."""
    codes = RUNNABLE[row]
    fire, ok = FIXTURES[codes[0]]
    assert set(codes) <= _codes(fire)
    assert _codes(ok) == set()
    for src in (fire, ok):
        assert "def run(device)" in src


def _rows(results):
    return sorted((f.code, f.line, f.col, f.end_line)
                  for r in results for f in r.findings)


@pytest.mark.parametrize("code", ["JG008", "JG015", "JG016"])
@pytest.mark.parametrize("kind", ["fire", "ok"])
def test_language_agnostic_rules_match_the_reference(code, kind):
    """The reference's own fixture and the port's, through both
    analysers: equal findings of the rule."""
    sel = [code]
    i = 0 if kind == "fire" else 1
    for src in ((REF_FIXTURES / f"{code.lower()}_{kind}.py").read_text(),
                FIXTURES[code][i]):
        got = port.lint_source("x.py", src, rules=port.select_rules(sel))
        want = ref.lint_source("x.py", src, rules=ref.select_rules(sel))
        assert _rows([got]) == _rows([want])
        assert bool(got.findings) == (kind == "fire")


def _package(tmp_path, files):
    pkg = tmp_path / "xmod"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    for name, src in files.items():
        (pkg / name).write_text(src)
    return pkg


HELPERS = '''import torch
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram


def read_scale(t):
    return float(t.sum())


def log_step(x):
    print("step")
    return x


def draw(shape, gen):
    return torch.rand(shape, generator=gen)


def make_program(body, device):
    return GraphedProgram(body, device)
'''

WRAPPER = '''import torch
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram
from xmod import helpers


def run(device):
    x = torch.ones(4, device=device)
    gen = torch.Generator(device=device)

    def body():
        s = helpers.read_scale(x)
        helpers.log_step(x)
        return helpers.draw(4, gen) * s

    prog = GraphedProgram(body, device)
    held = prog()
    prog()
    return held


def run_built(device):
    x = torch.ones(4, device=device)
    prog = helpers.make_program(lambda: x * 2, device)
    a = prog()
    b = prog()
    return a, b
'''


def test_cross_module_facts(tmp_path):
    pkg = _package(tmp_path, {"helpers.py": HELPERS, "wrapper.py": WRAPPER})
    by = {Path(r.path).name: [f.code for f in r.findings]
          for r in port.lint_paths([str(pkg)], use_cache=False)}
    # the host read inside a helper lands where the tensor enters it
    assert "JG001" in by["wrapper.py"]
    # a helper a captured body calls runs at capture: its print too
    assert "JG002" in by["helpers.py"]
    # a generator handed to a helper that draws from it, unregistered
    assert "JG003" in by["wrapper.py"]
    # the output of a program held across its next replay (local), and of
    # a program a helper built (the cross-module form)
    assert "JG007" in by["wrapper.py"] and "JG020" in by["wrapper.py"]


def test_per_file_pass_is_blind(tmp_path):
    pkg = _package(tmp_path, {"helpers.py": HELPERS, "wrapper.py": WRAPPER})
    codes = {f.code for f in port.lint_file(str(pkg / "wrapper.py"))
             .findings}
    assert not codes & {"JG001", "JG003", "JG020"}


SELF_HELD = '''import torch
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram


class Runner:
    def __init__(self, device):
        self.buf = torch.zeros(4, device=device)
        self.prog = GraphedProgram(lambda: self.buf * 2, device,
                                   inputs=lambda: [self.buf])

    def two(self):
        a = self.prog()
        b = self.prog()
        return a + b

    def reset(self, device):
        self.buf = torch.ones(4, device=device)
'''

SELF_HELD_OK = '''import torch
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram


class Runner:
    def __init__(self, device):
        self.buf = torch.zeros(4, device=device)
        self.prog = GraphedProgram(lambda: self.buf * 2, device,
                                   inputs=lambda: [self.buf])

    def two(self):
        a = self.prog().clone()
        b = self.prog()
        return a + b

    def reset(self, device):
        self.buf.copy_(torch.ones(4, device=device))
'''


def test_self_held_program_and_rebound_input():
    res = port.lint_source("runner.py", SELF_HELD)
    lines = sorted(f.line for f in res.findings if f.code == "JG020")
    assert lines == [14, 17]   # the held output's read, the rebinding
    assert not [f for f in port.lint_source("runner.py", SELF_HELD_OK)
                .findings if f.code == "JG020"]


@pytest.mark.parametrize("src,codes", [
    # a capture block records its statements
    ("import torch\n"
     "def f(g, x):\n"
     "    y = torch.ones(3)\n"
     "    with torch.cuda.graph(g):\n"
     "        z = y.sum().item()\n"
     "    return z\n", {"JG001"}),
    # make_graphed_callables' callables take tensors
    ("import torch\n"
     "def step(x):\n"
     "    if x.sum() > 0:\n"
     "        return x\n"
     "    return -x\n"
     "fast = torch.cuda.make_graphed_callables(step, (torch.ones(2),))\n",
     {"JG006"}),
    # torch.compile targets, decorator form
    ("import torch\n"
     "@torch.compile\n"
     "def f(x):\n"
     "    return x * x.max().item()\n", {"JG001"}),
    # a method handed to GraphedProgram as self.m
    ("import torch\n"
     "from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram\n"
     "class S:\n"
     "    def __init__(self):\n"
     "        self.p = GraphedProgram(self.body, 'cuda')\n"
     "    def body(self):\n"
     "        print('replay?')\n", {"JG002"}),
    # a device-wide wait inside a captured lambda
    ("import torch\n"
     "from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram\n"
     "p = GraphedProgram(lambda: torch.cuda.synchronize(), 'cuda')\n",
     {"JG001"}),
    # static metadata and an eager function stay silent
    ("import torch\n"
     "from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram\n"
     "def run(x):\n"
     "    n = int(x.sum())\n"
     "    def body():\n"
     "        if x.shape[0] > 2 and x.dim() == 1 and len(x) > 0:\n"
     "            return x * x.numel()\n"
     "        return x\n"
     "    return GraphedProgram(body, 'cuda'), n\n", set()),
])
def test_capture_index_and_taint(src, codes):
    assert _codes(src) == codes


def test_compile_family_is_indexed_apart_from_captures():
    """``tracked_jit``'s callables form the compile family: eager, so a
    host read there is not a capture hazard."""
    from bigdl_tpu_torch.analysis.core import FileContext
    src = ("import torch\n"
           "from bigdl_tpu_torch.telemetry.profiling import tracked_jit\n"
           "def step(x):\n"
           "    return helper(x)\n"
           "def helper(x):\n"
           "    return float(x.sum())\n"
           "fam = tracked_jit(step, site='s')\n")
    idx = FileContext.parse("f.py", src).capture_index
    assert {f.name for f in idx.families} == {"step", "helper"}
    assert not idx.captured
    assert not port.lint_source("f.py", src).findings


def test_reseeding_into_a_repeat():
    fire = ("import torch\n"
            "def f():\n"
            "    g = torch.Generator()\n"
            "    g.manual_seed(3)\n"
            "    a = torch.rand(2, generator=g)\n"
            "    g.manual_seed(3)\n"
            "    b = torch.rand(2, generator=g)\n"
            "    return a, b\n")
    ok = fire.replace("g.manual_seed(3)\n    b", "g.manual_seed(4)\n    b")
    assert [f.line for f in port.lint_source("s.py", fire).findings] == [6]
    assert not port.lint_source("s.py", ok).findings
