"""The port's graftlint engine (``bigdl_tpu_torch/analysis``): suppression,
reporters, SARIF, the CLI, ``--changed``, the registry and the result
cache (the counterpart of ``tests/test_graftlint.py``'s engine classes).

The language-agnostic parts are held to the reference's on the same
inputs: JG000 and the unused-suppression report, ``render_json`` and
``render_sarif`` of equal findings (the tool's rule table aside),
``--changed`` on the same git tree, and the CLI's exit codes. No
wall-clock budget is asserted here: ``chip_smoke.py`` phase 3r reports
the analyser's cold and warm seconds.
"""

import json
from pathlib import Path

import pytest

import bigdl_tpu.analysis as ref
import bigdl_tpu_torch.analysis as port
from bigdl_tpu.analysis.__main__ import changed_files as ref_changed
from bigdl_tpu.analysis.__main__ import main as ref_main
from bigdl_tpu_torch.analysis import cache, core
from bigdl_tpu_torch.analysis.__main__ import changed_files
from bigdl_tpu_torch.analysis.__main__ import main as cli_main
from bigdl_tpu_torch.analysis.fixtures import FIXTURES

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "tests" / "resources" / "graftlint"
ALL_CODES = [f"JG{i:03d}" for i in range(1, 9)] + \
    [f"JG{i:03d}" for i in range(10, 21)]

HOST_READ = ("import torch\n"
             "from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram\n"
             "def run(x):\n"
             "    y = torch.ones(4)\n"
             "    def body():\n"
             "        return float(y.sum()){tail}\n"
             "    return GraphedProgram(body, 'cuda')\n")


def _src(tail=""):
    return HOST_READ.replace("{tail}", tail)


def _rows(results):
    return sorted((f.code, f.line, f.col, f.end_line)
                  for r in results for f in r.findings)


# ------------------------------------------------------------- suppression
def test_reasoned_suppression_suppresses():
    res = port.lint_source("<s>", _src(
        "  # graftlint: ignore[JG001] -- test fixture"))
    assert [f.code for f in res.findings] == []
    assert [f.code for f in res.suppressed] == ["JG001"]


def test_reasonless_suppression_is_rejected():
    res = port.lint_source("<s>", _src("  # graftlint: ignore[JG001]"))
    codes = [f.code for f in res.findings]
    assert "JG001" in codes and "JG000" in codes


def test_comment_lines_above_apply():
    src = _src().replace(
        "        return float",
        "        # graftlint: ignore[JG001] -- deliberate read\n"
        "        # (measured in PERF.md)\n"
        "        return float")
    res = port.lint_source("<s>", src)
    assert not res.findings and len(res.suppressed) == 1


def test_wrong_code_does_not_suppress():
    res = port.lint_source("<s>", _src(
        "  # graftlint: ignore[JG004] -- wrong code"))
    codes = [f.code for f in res.findings]
    assert "JG001" in codes and "JG000" in codes


def test_unused_check_skipped_under_select_subset():
    src = "def f(x):\n    return x + 1  # graftlint: ignore[JG004] -- for the program\n"
    res = port.lint_source("<s>", src,
                           rules=port.select_rules(select=["JG001"]))
    assert not res.findings


SUPPRESSIONS = '''def a(x=[]):  # graftlint: ignore[JG008]
    return x


def b(x=None):  # graftlint: ignore[JG008] -- stale
    return x


def c(x={}):  # graftlint: ignore[JG008] -- shared on purpose
    return x


def d(y=set()):
    # graftlint: ignore[JG008] -- deliberate
    # (two comment lines above the construct)
    return y


def e(z=[],
      w=1):  # graftlint: ignore[JG008] -- trailing line of the def
    return z
'''


@pytest.mark.parametrize("select", [None, ["JG008"], ["JG001"]])
def test_suppressions_match_the_reference(select):
    """JG000 (a bare ignore), the unused-suppression report and the
    suppressed set: equal to the reference's on one source."""
    got = port.lint_source("s.py", SUPPRESSIONS, rules=None if select is None
                           else port.select_rules(select))
    want = ref.lint_source("s.py", SUPPRESSIONS, rules=None if select is None
                           else ref.select_rules(select))
    assert _rows([got]) == _rows([want])
    assert [(f.code, f.line) for f in got.suppressed] == \
        [(f.code, f.line) for f in want.suppressed]
    assert [f.message for f in got.findings if f.code == "JG000"] == \
        [f.message for f in want.findings if f.code == "JG000"]
    if select != ["JG001"]:
        assert {f.code for f in got.findings} == {"JG000", "JG008"}


def test_syntax_error_is_jg000():
    res = port.lint_source("bad.py", "def f(:\n    pass\n")
    assert [f.code for f in res.findings] == ["JG000"]
    want = ref.lint_source("bad.py", "def f(:\n    pass\n")
    assert _rows([res]) == _rows([want])


# ---------------------------------------------------------------- reporters
def _pair(tmp_path):
    src = (REF_FIXTURES / "jg008_fire.py").read_text()
    path = tmp_path / "jg008_fire.py"
    path.write_text(src)
    sel = ["JG008"]
    return (port.lint_paths([str(path)], select=sel, use_cache=False),
            ref.lint_paths([str(path)], select=sel, use_cache=False))


def test_render_json_and_text_match_the_reference(tmp_path):
    got, want = _pair(tmp_path)
    assert port.render_json(got) == ref.render_json(want)
    assert port.render_text(got) == ref.render_text(want)
    payload = json.loads(port.render_json(got))
    assert payload["files"] == 1 and payload["findings"]


def test_sarif_matches_the_reference_but_its_rule_table(tmp_path):
    got, want = _pair(tmp_path)
    mine = json.loads(port.render_sarif(got))
    theirs = json.loads(ref.render_sarif(want))
    assert mine["version"] == theirs["version"] == "2.1.0"
    assert mine["$schema"] == theirs["$schema"]
    assert mine["runs"][0]["results"] == theirs["runs"][0]["results"]
    assert mine["runs"][0]["tool"]["driver"]["name"] == "graftlint"


def test_sarif_shape():
    results = [port.lint_source("fire.py", FIXTURES["JG001"][0])]
    doc = port.sarif_report(results)
    driver = doc["runs"][0]["tool"]["driver"]
    assert [r["id"] for r in driver["rules"]] == ALL_CODES
    for rule in driver["rules"]:
        assert rule["shortDescription"]["text"]
        assert rule["fullDescription"]["text"]
        assert rule["defaultConfiguration"]["level"] == "warning"
    res = doc["runs"][0]["results"]
    assert any(r["ruleId"] == "JG001" for r in res)
    for r in res:
        loc = r["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"]
        assert loc["region"]["startLine"] >= 1
        assert loc["region"]["startColumn"] >= 1
        assert driver["rules"][r["ruleIndex"]]["id"] == r["ruleId"]
    sup = port.sarif_report([port.lint_source("<s>", _src(
        "  # graftlint: ignore[JG001] -- test fixture"))])
    assert sup["runs"][0]["results"][0]["suppressions"] == [
        {"kind": "inSource"}]


def test_cli_sarif_flags(tmp_path, capsys):
    fire = tmp_path / "fire.py"
    fire.write_text(FIXTURES["JG001"][0])
    ok = tmp_path / "ok.py"
    ok.write_text(FIXTURES["JG001"][1])
    out_path = tmp_path / "report.sarif"
    assert cli_main([str(fire), "--sarif", str(out_path),
                     "--no-cache"]) == 1
    assert json.loads(out_path.read_text())["version"] == "2.1.0"
    capsys.readouterr()
    assert cli_main([str(ok), "--format", "sarif", "--no-cache"]) == 0
    assert json.loads(capsys.readouterr().out)["runs"][0]["results"] == []


# ---------------------------------------------------------------- CLI codes
@pytest.mark.parametrize("argv,code", [
    (["{fx}/jg008_fire.py", "--select", "JG008", "--no-cache"], 1),
    (["{fx}/jg008_ok.py", "--select", "JG008", "--no-cache"], 0),
    (["--list-rules"], 0),
    (["--select", "NOPE", "{fx}"], 2),
    (["--ignore", "JG999", "{fx}"], 2),
    (["{fx}/no_such_dir"], 2),
    (["--changed", "no-such-ref-xyz", "{fx}"], 2),
], ids=["findings", "clean", "list", "bad-select", "bad-ignore",
        "missing-path", "bad-ref"])
def test_exit_codes_match_the_reference(argv, code, capsys):
    args = [a.replace("{fx}", str(REF_FIXTURES)) for a in argv]
    mine = cli_main(list(args))
    theirs = ref_main(list(args))
    capsys.readouterr()
    assert mine == theirs == code


def test_list_rules_names_every_code(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in ALL_CODES:
        assert code in out
    assert "JG009" not in out


# ------------------------------------------------------------------ changed
def test_changed_files_match_the_reference():
    assert changed_files("HEAD", [str(REF_FIXTURES)]) == \
        ref_changed("HEAD", [str(REF_FIXTURES)])
    files = changed_files("HEAD", [str(REPO / "bigdl_tpu_torch")])
    assert all(f.endswith(".py") and Path(f).exists() for f in files)


def test_changed_vs_head_smoke(capsys):
    assert cli_main(["--changed", "HEAD", "--no-cache",
                     str(REF_FIXTURES / "jg008_ok.py")]) == 0


# ----------------------------------------------------------------- registry
def test_nineteen_rules_registered():
    rules = port.all_rules()
    assert [r.code for r in rules] == ALL_CODES
    for rule in rules:
        assert rule.summary and (rule.__doc__ or "").strip()
    assert [r.code for r in ref.all_rules()] == ALL_CODES


def test_unknown_code_rejected():
    with pytest.raises(ValueError):
        port.select_rules(select=["JG999"])


def test_select_and_ignore():
    src = FIXTURES["JG013"][0]
    only = port.lint_source("f.py", src, rules=port.select_rules(["JG013"]))
    assert {f.code for f in only.findings} == {"JG013"}
    none = port.lint_source("f.py", src,
                            rules=port.select_rules(ignore=["JG013"]))
    assert "JG013" not in {f.code for f in none.findings}


# -------------------------------------------------------------------- cache
def _tree(tmp_path, src):
    tree = tmp_path / "tree"
    tree.mkdir(exist_ok=True)
    (tree / "a.py").write_text(src)
    return tree


def test_warm_hit_equals_cold_and_parses_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFTLINT_CACHE", str(tmp_path / "cache"))
    tree = _tree(tmp_path, FIXTURES["JG004"][0])
    cold = port.lint_paths([str(tree)])
    assert list((tmp_path / "cache").glob("*.json"))

    def refuse(*a, **k):
        raise AssertionError("a cache hit parsed a file")
    monkeypatch.setattr(core.FileContext, "parse", refuse)
    warm = port.lint_paths([str(tree)])
    assert port.render_json(warm) == port.render_json(cold)
    assert {f.code for r in warm for f in r.findings} == {"JG004"}


def test_an_edit_busts_the_key(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFTLINT_CACHE", str(tmp_path / "cache"))
    tree = _tree(tmp_path, FIXTURES["JG004"][1])
    assert not any(r.findings for r in port.lint_paths([str(tree)]))
    (tree / "a.py").write_text(FIXTURES["JG004"][0])
    edited = port.lint_paths([str(tree)])
    assert {f.code for r in edited for f in r.findings} == {"JG004"}


def test_rule_selection_is_part_of_the_key(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFTLINT_CACHE", str(tmp_path / "cache"))
    tree = _tree(tmp_path, FIXTURES["JG004"][0])
    full = port.lint_paths([str(tree)])
    narrowed = port.lint_paths([str(tree)], select=["JG001"])
    assert {f.code for r in full for f in r.findings} == {"JG004"}
    assert not any(r.findings for r in narrowed)


def test_the_key_covers_the_analysers_own_sources():
    root = Path(core.__file__).parent
    cache.analysis_digest.cache_clear()
    before = cache.analysis_digest()
    assert before == cache.analysis_digest()
    names = {p.name for p in root.rglob("*.py")}
    assert {"core.py", "program.py", "sarif.py"} <= names
    assert before != cache.program_key({}, ["JG001"])


def test_cli_no_cache_flag(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFTLINT_CACHE", str(tmp_path / "cache"))
    src = tmp_path / "clean.py"
    src.write_text("x = 1\n")
    assert cli_main([str(src), "--no-cache"]) == 0
    assert not list((tmp_path / "cache").glob("*.json"))
