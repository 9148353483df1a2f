"""graftlint in the port (``mingpt_distributed_tpu_torch/analysis``): one
counterpart for each case of ``tests/test_graftlint.py`` that concerns the
engine or the rules the port registers (GL007 to GL010), a parity check
against the JAX linter on the shared fixture corpus, and the port-wide
zero-finding gate.

The JAX-idiom rules (GL001 to GL006, GL011) have no counterpart (the
analysis package's docstring says why), so the suppression and baseline
cases use GL007 and GL010 where the JAX cases use GL002 and GL003, and
the fixture expectations are the ``# expect:`` markers of the port's
rules only.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from mingpt_distributed_tpu.analysis import Config as JConfig
from mingpt_distributed_tpu.analysis import Engine as JEngine
from mingpt_distributed_tpu_torch.analysis import Config, Engine, all_rules
from mingpt_distributed_tpu_torch.analysis.cli import main as lint_main
from mingpt_distributed_tpu_torch.analysis.core import Baseline
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mingpt_distributed_tpu_torch")
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
PORT_RULES = ("GL007", "GL008", "GL009", "GL010")
_EXPECT_RE = re.compile(r"expect:\s*(GL\d{3})")


def _markers(name):
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    return {i: {r for r in _EXPECT_RE.findall(t) if r in PORT_RULES}
            for i, t in enumerate(lines, start=1)}


def _disables_a_port_rule(name):
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        text = fh.read()
    return any(f"={r}" in text for r in PORT_RULES)


#: the fixtures that exercise a port rule, and those that suppress one
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py")
                       and any(_markers(f).values()))
SUPPRESSING = [f for f in FIXTURE_FILES if _disables_a_port_rule(f)]

FIXTURE_CONFIG = Config(
    clock_paths=("lint_fixtures/",),
    print_paths=("lint_fixtures/",),
    print_exempt_paths=(),
)

#: the suppression, baseline and exit-code cases lint files under pytest's
#: tmp_path: every path is in scope (the JAX cases' GL002/GL003 have none)
TMP_CONFIG = Config(clock_paths=("",), print_paths=("",), print_exempt_paths=())


def run_lint(paths, config=FIXTURE_CONFIG, **kwargs):
    return Engine(config=config, root=REPO, **kwargs).run(paths)


def _write(tmp_path, body, name="mod.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def _port(*parts):
    return os.path.join(PORT, *parts)


# ---------------------------------------------------------------------
# fixture corpus
# ---------------------------------------------------------------------


def test_the_port_registers_exactly_the_portable_rules():
    assert [cls.id for cls in all_rules()] == list(PORT_RULES)
    assert len(FIXTURE_FILES) >= 10 and len(SUPPRESSING) >= 8


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_expectations(name):
    """The port rules' marked lines fire, unmarked lines don't."""
    expected = {i: ids for i, ids in _markers(name).items() if ids}
    res = run_lint([os.path.join(FIXTURES, name)])
    assert not res.parse_errors
    got = {}
    for f in res.active:
        got.setdefault(f.line, set()).add(f.rule_id)
    assert got == expected


@pytest.mark.parametrize("name", SUPPRESSING)
def test_fixture_suppressions(name):
    res = run_lint([os.path.join(FIXTURES, name)])
    assert res.suppressed_count >= 1
    assert all(not f.active for f in res.findings if f.suppressed)


def test_every_rule_has_a_firing_fixture():
    res = run_lint([os.path.join(FIXTURES, f) for f in FIXTURE_FILES])
    fired = {f.rule_id for f in res.findings}
    assert fired == {cls.id for cls in all_rules()}


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_findings_equal_the_jax_linters(name):
    """Parity: both linters over the same fixture source give the same
    (id, path, line, message) for the port's rules, active and suppressed
    alike."""
    path = os.path.join(FIXTURES, name)
    jcfg = JConfig(clock_paths=("lint_fixtures/",), print_paths=("lint_fixtures/",),
                   print_exempt_paths=())
    jax_res = JEngine(config=jcfg, root=REPO, select=list(PORT_RULES)).run([path])
    port_res = run_lint([path])

    def rows(res):
        return [(f.rule_id, f.path, f.line, f.message, f.suppressed) for f in res.findings]

    assert rows(port_res) == rows(jax_res)
    assert rows(port_res)


# ---------------------------------------------------------------------
# suppression grammar
# ---------------------------------------------------------------------


def test_disable_next_and_disable_file(tmp_path):
    path = _write(tmp_path, """\
        # graftlint: disable-file=GL007
        import time

        def f():
            time.sleep(1)
            print("a")
            # graftlint: disable-next=GL010
            print("b")
            return print("c")
        """)
    res = run_lint([path], TMP_CONFIG)
    # GL007 disabled for the whole file; one GL010 disabled by
    # disable-next; the other two GL010 (lines 6 and 9) are active
    assert {f.rule_id for f in res.active} == {"GL010"}
    assert sorted(f.line for f in res.active) == [6, 9]
    assert res.suppressed_count == 2


def test_disable_all_keyword(tmp_path):
    path = _write(tmp_path, """\
        def f(x):
            print(x)  # graftlint: disable=all
        """)
    res = run_lint([path], TMP_CONFIG)
    assert not res.active
    assert res.suppressed_count == 1


def test_multiline_statement_trailing_comment(tmp_path):
    path = _write(tmp_path, """\
        def f(x, y):
            print(
                x + y
            )  # graftlint: disable=GL010
        """)
    res = run_lint([path], TMP_CONFIG)
    assert not res.active
    assert res.suppressed_count == 1


# ---------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------


def _baseline_file(tmp_path, entries):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"schema": "graftlint-baseline/1", "entries": entries}))
    return str(p)


def test_baseline_is_content_anchored(tmp_path):
    body = """\
        def f(x):
            print(x)
        """
    path = _write(tmp_path, body)
    bl = Baseline.load(_baseline_file(tmp_path, [{
        "rule": "GL010", "path": "mod.py", "contains": "print(x)",
        "justification": "fixture"}]))
    res = Engine(config=TMP_CONFIG, baseline=bl, root=REPO).run([path])
    assert not res.active and res.baselined_count == 1
    assert not res.stale_baseline
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# one\n# two\n# three\n" + textwrap.dedent(body))
    res = Engine(config=TMP_CONFIG, baseline=bl, root=REPO).run([path])
    assert not res.active and res.baselined_count == 1


def test_stale_baseline_entries_are_reported(tmp_path):
    path = _write(tmp_path, "x = 1\n")
    bl = Baseline.load(_baseline_file(tmp_path, [{
        "rule": "GL010", "path": "mod.py", "contains": "print(",
        "justification": "fixed long ago"}]))
    res = Engine(config=TMP_CONFIG, baseline=bl, root=REPO).run([path])
    assert res.exit_code == 0
    assert [e.rule for e in res.stale_baseline] == ["GL010"]
    assert "stale baseline" in res.render_human()


def test_baseline_rejects_bad_schema(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"schema": "nope/9", "entries": []}))
    with pytest.raises(ValueError):
        Baseline.load(str(p))


# ---------------------------------------------------------------------
# engine / CLI surface
# ---------------------------------------------------------------------


def test_exit_codes(tmp_path):
    assert run_lint([_write(tmp_path, "x = 1\n")], TMP_CONFIG).exit_code == 0
    assert run_lint([_write(tmp_path, "print(1)\n", "dirty.py")], TMP_CONFIG).exit_code == 1
    res = run_lint([_write(tmp_path, "def f(:\n", "broken.py")], TMP_CONFIG)
    assert res.exit_code == 1 and res.parse_errors


def test_select_unknown_rule_is_usage_error():
    with pytest.raises(ValueError):
        Engine(select=["GL999"], root=REPO)
    assert lint_main(["--select", "GL999", "."]) == 2
    with pytest.raises(ValueError):  # a JAX-idiom rule is unknown here
        Engine(select=["GL002"], root=REPO)


def _clean(paths, select):
    cfg = Engine(select=select, root=REPO).config
    for p in paths:
        rel = os.path.relpath(p, REPO)
        assert cfg.clock_in_scope(rel), f"{rel} fell out of GL007 scope"
    res = Engine(select=select, root=REPO).run(paths)
    assert not res.parse_errors
    assert res.findings == []  # not even suppressed or baselined ones


def _package(*parts):
    pkg = _port(*parts)
    return sorted(os.path.join(pkg, f) for f in os.listdir(pkg) if f.endswith(".py"))


def test_tracing_modules_clean_under_clock_rule():
    _clean([_port("telemetry", p) for p in ("tracing.py", "flightrec.py")], ["GL007"])


def test_speculative_module_clean_under_clock_rule():
    _clean([_port("serving", "speculative.py")], ["GL007"])


def test_sharded_engine_modules_clean_under_clock_rule():
    _clean([_port("serving", p) for p in ("engine.py", "kv_pool.py")], ["GL007"])


def test_quant_module_clean_under_clock_rule():
    _clean([_port("serving", "quant.py")], ["GL007"])


def test_trafficlab_package_clean_under_clock_rule():
    paths = _package("trafficlab")
    assert len(paths) >= 5
    _clean(paths, ["GL007"])


def test_procfleet_package_clean_under_clock_rule():
    paths = _package("serving", "procfleet")
    assert len(paths) >= 5
    assert "serving/procfleet/" in Engine(select=["GL007"], root=REPO).config.clock_paths
    _clean(paths, ["GL007"])


def test_hostplane_module_clean_under_clock_rule():
    path = _port("serving", "procfleet", "hostplane.py")
    assert "serving/procfleet/hostplane.py" in Engine(root=REPO).config.clock_paths
    with open(path, encoding="utf-8") as fh:
        assert "import time" not in fh.read()
    _clean([path], ["GL007"])


def test_control_package_clean_under_clock_and_name_rules():
    paths = _package("control")
    assert len(paths) >= 5
    assert "control/" in Engine(root=REPO).config.clock_paths
    _clean(paths, ["GL007"])
    res = Engine(select=["GL008", "GL009"], root=REPO).run(paths)
    assert not res.parse_errors and res.findings == []


def test_attribution_module_clean_under_clock_and_name_rules():
    path = _port("telemetry", "attribution.py")
    _clean([path], ["GL007"])
    res = Engine(select=["GL008", "GL009"], root=REPO).run([path])
    assert not res.parse_errors and res.findings == []


def test_list_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == list(PORT_RULES)


def test_json_envelope(tmp_path, capsys):
    dirty = str(tmp_path / "dirty.py")
    with open(dirty, "w", encoding="utf-8") as fh:
        fh.write("import sys\n\n\ndef f(x):\n    print(x)\n")
    cfg_dir = tmp_path / "mingpt_distributed_tpu_torch"
    cfg_dir.mkdir()
    lib = str(cfg_dir / "lib.py")
    with open(lib, "w", encoding="utf-8") as fh:
        fh.write("def f(x):\n    print(x)\n")
    code = lint_main(["--json", "--no-baseline", dirty, lib])
    doc = json.loads(capsys.readouterr().out)
    assert code == 1
    assert doc["schema"] == "graftlint/1"
    assert doc["summary"]["files"] == 2
    assert doc["summary"]["findings"] == 1  # only library code is in GL010 scope
    assert doc["summary"]["per_rule"] == {"GL010": 1}
    f = doc["findings"][0]
    assert f["rule"] == "GL010" and f["line"] == 2
    assert not f["suppressed"] and not f["baselined"]


def test_sweep_skips_fixture_corpus_but_lints_explicit_files():
    sweep = run_lint([os.path.join(REPO, "tests")])
    assert not any("lint_fixtures" in f.path for f in sweep.findings)
    direct = run_lint([os.path.join(FIXTURES, "gl010_print.py")])
    assert any(f.rule_id == "GL010" for f in direct.active)


# ---------------------------------------------------------------------
# the port-wide gate
# ---------------------------------------------------------------------


def test_lint_clean():
    """``python -m mingpt_distributed_tpu_torch.analysis`` sweeps the
    port's package (its tools/ included) with zero unsuppressed findings,
    from the repository root and from anywhere else."""
    for cwd in (REPO, os.path.join(REPO, "tests")):
        proc = subprocess.run(
            [sys.executable, "-m", "mingpt_distributed_tpu_torch.analysis"],
            cwd=cwd, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 findings" in proc.stdout
        assert int(proc.stdout.split("graftlint: ")[1].split()[0]) >= 100
