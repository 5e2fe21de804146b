"""The port's lint (lightgbm_tpu_torch/analysis/) on the CPU: its engine
(astscan, callgraph, cfg, dataflow) gives the JAX package's outputs on
the same sources — the JAX lint fixtures and a few port modules — with
the JAX package's rank sources; every port rule fires on its positive
fixture (``tests/torch_analysis_fixtures/``, ``# EXPECT: TPLNNN`` on the
line before each finding) and stays silent on its negative one;
mutations of the port (a second read-back in ``Grower._split``, a
collective under a rank branch, a stale baseline entry, one more aten
op a split) each fail the lint; the JAX rules without a port rule are
usage errors naming their ROADMAP.md entry; and one run over the whole
tree, in a subprocess, is clean and imports no torch.
"""

import ast
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from lightgbm_tpu.analysis import callgraph as jcg
from lightgbm_tpu.analysis import cfg as jcfg
from lightgbm_tpu.analysis import dataflow as jdf
from lightgbm_tpu_torch.analysis import callgraph as tcg
from lightgbm_tpu_torch.analysis import cfg as tcfg
from lightgbm_tpu_torch.analysis import dataflow as tdf
from lightgbm_tpu_torch.analysis import ircheck
from lightgbm_tpu_torch.analysis import rules as trules
from lightgbm_tpu_torch.analysis.baseline import load_baseline
from lightgbm_tpu_torch.analysis.cli import main as lint_main
from lightgbm_tpu_torch.analysis.engine import (default_baseline_path,
                                                package_root, run_lint)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PKG = package_root()
JAX_FIXTURES = os.path.join(TESTS, "analysis_fixtures")
FIXTURES = os.path.join(TESTS, "torch_analysis_fixtures")
BASELINE = default_baseline_path()

_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*(TPL\d{3})\s*$")


def _expected(path):
    out = []
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh, start=1):
            m = _EXPECT_RE.search(line)
            if m:
                out.append((m.group(1), i + 1))
    return sorted(out)


# ---- the engine is the JAX package's ----------------------------------

def _engine_facts(cg, cfg, df, root, package, files, **taint_kw):
    """Everything the engine computes over a set of sources, as plain
    data: the scans' functions, imports, aliases and pragmas; the call
    records, call edges and jit-reachable set; each statement's guard
    pins, except/finally flags and lock-held set; rank taint; the
    thread-side closure; the float64 producers."""
    scans = cg.scan_package(root, package=package, files=files)
    graph = cg.CallGraph(scans)
    out = {"scans": {s.relpath: (
        sorted(s.funcs), sorted(s.imports.items()), sorted(s.aliases),
        sorted(s.hot_lines), sorted((k, sorted(v))
                                    for k, v in s.disable_lines.items()),
        sorted(s.threadsafe_lines.items()),
        sorted(s.replicated_cond_lines.items())) for s in scans}}
    out["edges"] = sorted((r.scope or ("", ""), r.target, r.kind, r.lineno)
                          for r in graph.refs)
    out["records"] = sorted(
        (k or ("", ""), r.kind, r.dotted or "", r.attr or "",
         r.target or ("", ""), r.node.lineno, r.node.col_offset, r.in_loop)
        for k, f in graph.facts.items() for r in f.records)
    out["jit"] = sorted(graph.jit_reachable)
    tainted = df.rank_tainted_returns(graph, **taint_kw)
    out["tainted_fns"] = sorted(tainted)
    flow = {}
    for key, info in sorted(graph.funcs.items()):
        c = cfg.FunctionCFG(info.node)
        rows = []
        for node in ast.walk(info.node):
            if not isinstance(node, ast.stmt):
                continue
            u = c.info(node)
            if u is None:
                continue
            rows.append((node.lineno, node.col_offset,
                         [(ast.unparse(t), p) for t, p in u.pins],
                         u.in_except, u.in_finally, sorted(u.held_locks),
                         u.reachable))
        taint = df.RankTaint(info.node, tainted_fns=tainted, **taint_kw)
        flow[key] = (sorted(rows), sorted(taint.names))
    out["flow"] = flow
    out["thread_side"] = sorted(
        (k, v) for k, v in df.thread_side_functions(graph).items())
    f64 = []
    for s in scans:
        for node in ast.walk(s.tree):
            if isinstance(node, ast.expr) \
                    and df.is_float64_expr(node, s.imports):
                f64.append((s.relpath, node.lineno, node.col_offset))
    out["f64"] = sorted(f64)
    return out


@pytest.mark.parametrize("root,package,files", [
    (JAX_FIXTURES, "tpulint_fixtures", None),
    (PKG, "lightgbm_tpu_torch",
     ["parallel/spmd.py", "parallel/hostsync.py", "parallel/comms.py",
      "resilience/watchdog.py", "serve/batcher.py", "obs/cost.py",
      "ops/split.py"])], ids=["jax_fixtures", "port_modules"])
def test_engine_equals_the_jax_packages(root, package, files):
    port = _engine_facts(tcg, tcfg, tdf, root, package, files,
                         sources=tdf.JAX_RANK_SOURCES)
    ref = _engine_facts(jcg, jcfg, jdf, root, package, files)
    for key in ref:
        assert port[key] == ref[key], key
    assert ref["records"] and ref["flow"]


# ---- every rule's fixtures --------------------------------------------

_FIXTURES = [
    "tpl002_pos.py", "tpl002_neg.py", "tpl003_pos.py", "tpl003_neg.py",
    "parallel/tpl005_pos.py", "parallel/tpl005_neg.py",
    "obs/tpl006_pos.py", "obs/tpl006_neg.py",
    "tpl007_pos.py", "tpl007_neg.py",
    "obs/tpl008_pos.py", "obs/tpl008_neg.py",
    "tpl009_pos.py", "tpl009_neg.py", "tpl010_pos.py", "tpl010_neg.py"]
_CONTRACT = [f"contract/tpl0{n}_{k}.py" for n in (15, 16, 17, 18)
             for k in ("pos", "neg")]
_GROUPS = [(("contract/obs/schemas.py", rel), rel) for rel in _CONTRACT] \
    + [(("contract/agg/obs/schemas.py", "contract/agg/site.py"),
        "contract/agg/obs/schemas.py")]


@pytest.mark.parametrize("files,target",
                         [((rel,), rel) for rel in _FIXTURES] + _GROUPS,
                         ids=_FIXTURES + [g[1] for g in _GROUPS])
def test_rule_fixture(files, target):
    res = run_lint(root=FIXTURES, package="tpulint_fixtures",
                   files=list(files), baseline_path="")
    got = sorted((f.rule, f.lineno) for f in res.findings
                 if f.relpath == target)
    want = _expected(os.path.join(FIXTURES, target))
    assert got == want, [(f.fid, f.lineno, f.message[:90])
                         for f in res.findings]
    assert bool(want) == ("_pos" in target or "/agg/" in target)


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        "fixture_" + rel.replace("/", "_")[:-3],
        os.path.join(FIXTURES, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["pos", "neg"])
def test_runtime_rule_fixtures(kind):
    """TPL011 (float64 sites against the declared list), TPL012 (a
    split's aten ops against its budget) and TPL014 (register_jit sites
    without max_signatures), each on its positive and negative file."""
    m = _load(f"ir/tpl011_{kind}.py")
    _, sites = ircheck.op_census(m.entry, torch.ones(3), pkg_dir=FIXTURES)
    got = ircheck.f64_findings(
        ircheck._Measured(f64={"fixture": sites}),
        {"fixture@default": {"float64_sites": m.DECLARED}})
    assert sorted((f.rule, f.lineno) for f in got) \
        == _expected(os.path.join(FIXTURES, f"ir/tpl011_{kind}.py"))
    m = _load(f"ir/tpl012_{kind}.py")
    n, _ = ircheck.op_census(m.split, torch.ones(5, 3), pkg_dir=FIXTURES)
    got = ircheck.budget_findings({"aten_ops_per_split": n}, m.BUDGET,
                                  "fixture@split", "ir", "split")
    assert [f.rule for f in got] == (["TPL012"] if kind == "pos" else [])
    got = [(f.rule, f.lineno) for f in ircheck.recompile_surface_findings(
        os.path.join(FIXTURES, "ir")) if f.relpath == f"tpl014_{kind}.py"]
    assert got == _expected(os.path.join(FIXTURES, f"ir/tpl014_{kind}.py"))


def test_every_port_rule_has_a_positive_fixture():
    covered = set()
    for rel in _FIXTURES + _CONTRACT + ["contract/agg/obs/schemas.py",
                                        "ir/tpl011_pos.py",
                                        "ir/tpl014_pos.py"]:
        covered |= {r for r, _ in _expected(os.path.join(FIXTURES, rel))}
    covered.add("TPL012")   # its finding has no line: asserted above
    assert {r.id for r in trules.ALL_RULES + trules.IR_RULES} <= covered


@pytest.mark.parametrize("rid", sorted(trules.NO_COUNTERPART))
def test_jax_rules_without_a_port_rule_are_usage_errors(rid, capsys):
    assert lint_main(["--rule", rid]) == 2
    err = capsys.readouterr().err
    assert rid in err and "ROADMAP.md Queue 3" in err
    with pytest.raises(ValueError, match="ROADMAP.md Queue 3"):
        run_lint(rules=[rid])


# ---- the tree ------------------------------------------------------------

@pytest.fixture(scope="module")
def whole_tree():
    """One lint of the whole tree in fresh interpreters, as JSON (with
    ``-X importtime`` listing every module it imported) and as SARIF,
    the two at once."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIGHTGBM_TPU_")}
    env["PYTHONPATH"] = REPO
    procs = {fmt: subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "lightgbm_tpu_torch",
         "lint", "--strict", "--format", fmt], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fmt in ("json", "sarif")}
    out = {fmt: (p.communicate(timeout=300), p.returncode)
           for fmt, p in procs.items()}
    return out


def test_the_tree_lints_clean_without_torch(whole_tree):
    (stdout, stderr), rc = whole_tree["json"]
    assert rc == 0, stdout[-3000:]
    out = json.loads(stdout)
    assert out["findings"] == [] and out["stale_baseline"] == []
    assert out["baselined"] and out["hot_reachable"]
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in stderr.splitlines()
                if line.startswith("import time:")}
    assert "lightgbm_tpu_torch.analysis.engine" in imported
    assert not {m for m in imported if m.split(".")[0] == "torch"}


def test_sarif_output(whole_tree):
    (stdout, _), rc = whole_tree["sarif"]
    assert rc == 0
    sarif = json.loads(stdout)
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} \
        == {r.id for r in trules.ALL_RULES + trules.IR_RULES}
    assert run["results"] and all(r["suppressions"]
                                  for r in run["results"])


def test_every_baseline_and_budget_entry_is_justified():
    entries = load_baseline(BASELINE)
    assert entries and all(e.justification.strip() for e in entries)
    budgets, unjustified = ircheck.load_budgets(
        ircheck.default_budgets_path())
    assert budgets and not unjustified
    assert ircheck.recompile_surface_findings(PKG) == []


def _tree_copy(tmp_path):
    dst = tmp_path / "lightgbm_tpu_torch"
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "_build", "csrc", "native"))
    return dst


def _edit(path, anchor, insert):
    text = path.read_text()
    assert anchor in text, anchor
    path.write_text(text.replace(anchor, anchor + insert, 1))


@pytest.fixture(scope="module")
def mutated(tmp_path_factory):
    """The tree with two faults put in, linted once: a second read-back
    in ``Grower._split`` and a collective under a rank branch."""
    dst = _tree_copy(tmp_path_factory.mktemp("mutated"))
    _edit(dst / "ops" / "grow.py",
          "    def _split(self, st, leaf: int, r: np.ndarray) -> None:"
          "  # tpulint: hot\n",
          "        self._probe = self.hists[0].sum().item()\n")
    _edit(dst / "parallel" / "data_parallel.py",
          "    def reduce_hist_once(self, x: torch.Tensor) -> torch.Tensor:\n",
          "        if self.comm.rank == 0:\n"
          "            self.comm.all_reduce(x)\n")
    return run_lint(root=str(dst), rules=["TPL002", "TPL007"],
                    baseline_path=BASELINE)


def test_a_second_readback_in_a_split_fails(mutated):
    """TPL002, the static guard of one read-back a split: a second
    ``.item()`` in ``Grower._split`` is a finding no baseline entry
    covers."""
    assert [(f.func, f.symbol) for f in mutated.findings
            if f.rule == "TPL002"] == [("Grower._split", ".item()")]


def test_a_collective_under_a_rank_branch_fails(mutated):
    assert [(f.func, f.symbol) for f in mutated.findings
            if f.rule == "TPL007"] == [("DistGrow.reduce_hist_once",
                                        "collective:all_reduce")]


def test_a_stale_baseline_entry_fails_strict(tmp_path, capsys):
    """A baseline entry whose finding no longer occurs passes a plain
    run and fails ``--strict`` (on a one-module tree: the discipline is
    the engine's, whatever the tree)."""
    tree = tmp_path / "pkg"
    (tree / "obs").mkdir(parents=True)
    shutil.copy(os.path.join(FIXTURES, "obs", "tpl006_neg.py"),
                tree / "obs" / "recorder.py")
    stale = tmp_path / "baseline.txt"
    stale.write_text("TPL006:obs/recorder.py:Recorder.record:"
                     "lock-dispatch:.to()#1  # fixed since\n")
    argv = ["--root", str(tree), "--rule", "TPL006", "--baseline",
            str(stale)]
    assert lint_main(argv) == 0
    assert lint_main(argv + ["--strict"]) == 1
    assert "Recorder.record:lock-dispatch" in capsys.readouterr().out


def test_one_more_aten_op_a_split_breaks_the_launch_budget(monkeypatch):
    """The budget is the unmutated tree's most aten ops a split (pinned
    exactly), so one more a split is one over it."""
    budget = ircheck.load_budgets(ircheck.default_budgets_path())[0][
        "ops/grow_tree@split"]
    from lightgbm_tpu_torch.ops import grow
    split = grow.Grower._split

    def one_more(self, *args, **kwargs):
        torch.zeros(1)
        return split(self, *args, **kwargs)

    monkeypatch.setattr(grow.Grower, "_split", one_more)
    measured = ircheck.measure_entries(["train"])
    got = ircheck.budget_findings(
        {"aten_ops_per_split": max(measured.split_ops)}, budget,
        "ops/grow_tree@split", "ops/grow.py", "Grower._split")
    assert [f.rule for f in got] == ["TPL012"]
    assert f"{budget['aten_ops_per_split'] + 1} over" in got[0].message


def test_the_recorder_bumps_jit_recompiles_as_the_jax_one_does(tmp_path):
    """The contract pass found ``jit_recompiles`` declared and never
    bumped in the port: the recorder now feeds it from each iteration's
    ``recompiles`` delta, as the JAX recorder does."""
    import numpy as np
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.obs.registry import MetricsRegistry
    rs = np.random.RandomState(0)
    X = rs.randn(400, 4).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    reg = MetricsRegistry()
    cpu = {"device_type": "cpu", "verbosity": -1}
    tlgb.train({"objective": "binary", "num_leaves": 7, **cpu},
               tlgb.Dataset(X, label=y, params=cpu), 2,
               callbacks=[tlgb.telemetry(str(tmp_path / "t.jsonl"),
                                         registry=reg)])
    assert reg.snapshot()["jit_recompiles"]["kind"] == "counter"
