"""The port's analyzers (foundationdb_tpu_torch/analysis/) against the JAX ones.

Held to the JAX package:
  - on the reference lint suites' fixture sources (every multi-line string
    of tests/test_flowlint.py, test_protolint.py and test_natlint.py: the
    Python ones under the suites' snippet paths, the C ones through
    natlint), the port's flow, proto and nat rules give the same findings
    (rule, line, symbol, detail) as the JAX package's. FLOW006 is left out
    of this comparison: the port's is the torch rule, pinned below;
  - on every module of the port that is a line-for-line copy of the
    reference's (its imports renamed), the same findings with the path
    renamed.

The gate (the counterpart of scripts/lint.sh): the port's four families
over the port's package, with the port's baseline, give no new finding,
no stale entry and no FIXME reason, and the baseline has not drifted.

The torch rules: FLOW006 and every DEV rule with a counterpart pinned in
both directions, and a copy of server/resolver.py with `.item()` put into
a coroutine flagged. The CLI round trip. Every module this slice adds
imports neither jax nor anything of foundationdb_tpu.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from foundationdb_tpu.analysis import flowlint as j_flowlint
from foundationdb_tpu.analysis import natlint as j_natlint
from foundationdb_tpu_torch.analysis import flowlint, natlint
from foundationdb_tpu_torch.analysis.__main__ import main as lint_main

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "foundationdb_tpu_torch"
JAX = ROOT / "foundationdb_tpu"
SNIPPET_DIRS = ("server", "client", "layers", "ops")


def port_path(path: str) -> str:
    return path.replace("foundationdb_tpu/", "foundationdb_tpu_torch/", 1)


def to_port(source: str) -> str:
    """A source of the JAX package as the port's copy of it reads."""
    return source.replace("foundationdb_tpu", "foundationdb_tpu_torch") \
        .replace("foundationdb_tpu_torch_torch", "foundationdb_tpu_torch")


def compared_rules(module):
    """The flow and proto rules of one package's registry, but FLOW006."""
    return [r for r in module.active_rules()
            if r.family in ("flow", "proto") and r.code != "FLOW006"]


def keys(findings):
    return sorted((f.rule, f.line, f.symbol, f.detail) for f in findings)


def fixture_sources(test_file: str) -> tuple[list[str], list[str]]:
    """(Python sources, C sources): the dedented multi-line string
    constants of one reference lint suite."""
    tree = ast.parse((ROOT / "tests" / test_file).read_text())
    py, c = [], []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.count("\n") >= 2):
            continue
        src = textwrap.dedent(node.value)
        try:
            ast.parse(src)
        except SyntaxError:
            if ";" in src:
                c.append(src)
            continue
        py.append(src)
    return py, c


# ------------------------------------------------- held to the JAX package

@pytest.mark.parametrize("test_file", ["test_flowlint.py", "test_protolint.py",
                                       "test_natlint.py"])
def test_fixture_findings_equal_the_jax_analyzers(test_file):
    py, c = fixture_sources(test_file)
    j_rules, t_rules = compared_rules(j_flowlint), compared_rules(flowlint)
    flagged = 0
    for src in py:
        for sub in SNIPPET_DIRS:
            path = f"foundationdb_tpu/{sub}/snippet.py"
            want = keys(j_flowlint.analyze_source(src, path, j_rules))
            got = keys(flowlint.analyze_source(to_port(src), port_path(path),
                                               t_rules))
            assert got == want, f"{test_file} under {sub}/:\n{src}"
            flagged += bool(want)
    for src in c:
        want = keys(j_natlint.analyze_c_source(src))
        assert keys(natlint.analyze_c_source(src)) == want, src
        flagged += bool(want)
    assert len(py) + len(c) >= 10 and flagged >= 5, (len(py), len(c),
                                                     flagged)


def copied_modules() -> list[str]:
    """Package-relative paths of the port's modules that are the JAX
    package's line for line, with their imports renamed."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT)
        ref = JAX / rel
        if "__pycache__" in rel.parts or not ref.exists():
            continue
        if to_port(ref.read_text()) == path.read_text():
            out.append(rel.as_posix())
    return out


def test_copied_modules_give_the_jax_findings():
    rels = copied_modules()
    assert len(rels) >= 40, rels
    j_rules, t_rules = compared_rules(j_flowlint), compared_rules(flowlint)
    want = j_flowlint.analyze_paths([str(JAX / r) for r in rels], j_rules)
    got = flowlint.analyze_paths([str(PORT / r) for r in rels], t_rules)
    assert sorted((f.rule, port_path(f.path), f.line, f.symbol, f.detail)
                  for f in want) == \
        sorted((f.rule, f.path, f.line, f.symbol, f.detail) for f in got)


# ------------------------------------------------------------------- gate

@pytest.fixture(scope="module")
def package_findings():
    return flowlint.analyze_paths(flowlint.default_targets())


def test_port_package_is_clean_against_its_baseline(package_findings):
    baseline = flowlint.load_baseline(flowlint.default_baseline_path())
    new, stale = flowlint.apply_baseline(package_findings, baseline)
    assert new == [], flowlint.format_text(new)
    assert stale == [], stale


def test_port_baseline_reasons_are_written_and_carried():
    with open(flowlint.default_baseline_path(), encoding="utf-8") as f:
        entries = json.load(f)["entries"]
    with open(j_flowlint.default_baseline_path(), encoding="utf-8") as f:
        ref = {(e["rule"], port_path(e["path"]), e["symbol"], e["detail"]):
               e["reason"] for e in json.load(f)["entries"]}
    assert entries
    for e in entries:
        assert e["path"].startswith("foundationdb_tpu_torch/"), e
        reason = e.get("reason", "")
        assert len(reason) > 40 and not reason.startswith("FIXME"), e
        key = (e["rule"], e["path"], e["symbol"], e["detail"])
        if key in ref:
            assert reason == ref[key], e


def test_default_targets_are_the_port_package_alone():
    assert flowlint.default_targets() == [str(PORT)]
    assert flowlint.PACKAGE_NAME == "foundationdb_tpu_torch"


def test_baseline_has_not_drifted(capsys):
    assert lint_main(["--update-baseline", "--check"]) == 0
    assert "baseline up to date" in capsys.readouterr().err


def test_cli_roundtrip_and_baseline_workflow(tmp_path, capsys):
    bad = tmp_path / "foundationdb_tpu_torch" / "server" / "late.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(textwrap.dedent("""
        import time

        import torch

        class Role:
            async def tick(self):
                await self.step()
                time.sleep(1)
                return torch.ones(1).item()
    """))
    baseline = tmp_path / "baseline.json"
    rc = lint_main([str(bad), "--format=json", "--baseline", str(baseline)])
    findings = json.loads(capsys.readouterr().out)["findings"]
    assert rc == 1
    assert sorted(f["rule"] for f in findings) == ["DEV001", "FLOW001"]
    assert {f["path"] for f in findings} == {
        "foundationdb_tpu_torch/server/late.py"}
    assert lint_main([str(bad), "--baseline", str(baseline),
                      "--update-baseline"]) == 0
    data = json.loads(baseline.read_text())
    assert len(data["entries"]) == 2
    assert all(e["reason"].startswith("FIXME") for e in data["entries"])
    capsys.readouterr()
    assert lint_main([str(bad), "--baseline", str(baseline)]) == 0
    assert lint_main([str(bad), "--baseline", str(baseline),
                      "--update-baseline", "--check"]) == 0
    bad.write_text(textwrap.dedent("""
        class Role:
            async def tick(self):
                await self.step()
    """))
    assert lint_main([str(bad), "--baseline", str(baseline)]) == 0
    assert "stale baseline entry" in capsys.readouterr().err
    assert lint_main([str(bad), "--baseline", str(baseline),
                      "--update-baseline", "--check"]) == 1
    assert "baseline drift" in capsys.readouterr().err
    assert lint_main(["--family", "dev", "--list-rules"]) == 0
    assert [line.split()[0] for line in
            capsys.readouterr().out.splitlines()] == [
        "DEV001", "DEV002", "DEV003", "DEV005", "DEV007", "DEV008"]


# ------------------------------------------------------- the torch rules

OPS_PATH = "foundationdb_tpu_torch/ops/snippet.py"
SERVER_PATH = "foundationdb_tpu_torch/server/snippet.py"


def lint(source: str, path: str = OPS_PATH, family: str = "all"):
    return flowlint.analyze_source(textwrap.dedent(source), path,
                                   flowlint.active_rules(family))


def found(findings, code):
    return sorted(f.detail for f in findings if f.rule == code)


def test_flow006_flags_cuda_touched_at_import():
    findings = lint("""
        import ctypes

        import torch

        from foundationdb_tpu_torch import native
        from foundationdb_tpu_torch.ops import kernels

        NDEV = torch.cuda.device_count()
        ONES = torch.ones(4, device="cuda")
        MOVED = torch.zeros(2).cuda()
        LIB = kernels.library()
        SO = ctypes.CDLL("libx.so")
        MOD = native.mod
    """, family="flow")
    assert found(findings, "FLOW006") == sorted([
        "torch.cuda.device_count", "torch.ones(device=cuda)", ".cuda",
        "foundationdb_tpu_torch.ops.kernels.library", "ctypes.CDLL",
        "foundationdb_tpu_torch.native.mod"])
    assert all(f.symbol == "<module>" for f in findings)


def test_flow006_quiet_for_lazy_use_and_host_tensors():
    findings = lint("""
        import torch

        from foundationdb_tpu_torch import native
        from foundationdb_tpu_torch.ops import kernels

        CPU = torch.zeros(4)
        DEV = torch.device("cuda")
        NEG = -(1 << 30)

        def library():
            return kernels.library(), native.mod

        def ones():
            if torch.cuda.is_available():
                return torch.ones(4, device="cuda")
    """, family="flow")
    assert found(findings, "FLOW006") == []


def test_dev001_flags_readbacks_in_a_coroutine_interprocedurally():
    findings = lint("""
        import torch

        def read_back(x):
            return x.cpu()

        class Role:
            async def tick(self):
                x = torch.ones(3)
                await self.step()
                n = x.sum().item()
                torch.cuda.synchronize()
                self.event.synchronize()
                return read_back(x), n
    """, SERVER_PATH, family="dev")
    assert found(findings, "DEV001") == sorted([
        ".item", "torch.cuda.synchronize", ".synchronize", "read_back"])


def test_dev001_quiet_for_offloads_host_values_and_other_dirs():
    clean = """
        import numpy as np
        import torch

        class Role:
            async def tick(self, loop):
                x = torch.ones(3)
                n = await loop.run_blocking(lambda: x.sum().item())
                rows = np.arange(3).tolist()
                return n, rows
    """
    assert found(lint(clean, SERVER_PATH, "dev"), "DEV001") == []
    blocking = """
        import torch

        class Role:
            async def tick(self):
                return torch.ones(3).cpu()
    """
    assert found(lint(blocking, SERVER_PATH, "dev"), "DEV001") == [".cpu"]
    # layers/ is not sim-visible: its coroutines are the client's own
    assert found(lint(blocking, "foundationdb_tpu_torch/layers/x.py", "dev"),
                 "DEV001") == []


def test_resolver_with_an_item_readback_in_a_coroutine_is_flagged():
    src = (PORT / "server" / "resolver.py").read_text()
    path = "foundationdb_tpu_torch/server/resolver.py"
    assert found(flowlint.analyze_source(src, path,
                                         flowlint.active_rules("dev")),
                 "DEV001") == []
    anchor = "        cs = self.conflict_set\n"
    assert src.count(anchor) == 1
    mutant = src.replace(
        "from __future__ import annotations\n",
        "from __future__ import annotations\n\nimport torch\n", 1).replace(
        anchor, anchor + "        probe = torch.ones(1).item()\n")
    findings = flowlint.analyze_source(mutant, path,
                                       flowlint.active_rules("dev"))
    hits = [f for f in findings if f.rule == "DEV001"]
    assert [(f.symbol, f.detail) for f in hits] == [
        ("Resolver._resolve_batch", ".item")]


def test_dev002_flags_graphs_built_per_call():
    findings = lint("""
        import torch

        from foundationdb_tpu_torch.ops.step_graph import StepGraph

        def per_batch(batches, body):
            for b in batches:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    body(b)
                g.replay()

        def once(state):
            prog = StepGraph(state, txns=8, reads=8, writes=8)
            return prog.run()
    """, family="dev")
    assert found(findings, "DEV002") == sorted([
        "torch.cuda.CUDAGraph", "torch.cuda.graph", "StepGraph"])


def test_dev002_quiet_for_cached_graphs():
    findings = lint("""
        import torch

        from foundationdb_tpu_torch.ops.step_graph import ScanGraph, StepGraph

        class Engine:
            def graph(self, key, state):
                g = self._graphs.get(key)
                if g is None:
                    g = self._graphs[key] = StepGraph(state, txns=8,
                                                      reads=8, writes=8)
                return g

            def capture(self, body):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    body()
                self.graph = graph

        def program(state):
            return ScanGraph(state, steps=4)
    """, family="dev")
    assert found(findings, "DEV002") == []


CAPTURED = """
    import torch

    class Program:
        def _body(self, state, *, mode="scan"):
            {line}
            return state

        def capture(self):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._body(self.state)
            self.graph = graph
"""


@pytest.mark.parametrize("line,hit", [
    ("if state['nb'] > 5: state = state", ["state"]),
    ("flag = bool(state['poisoned'])", ["state"]),
    ("if mode == 'scan': state = state", []),
])
def test_dev003_branch_on_a_captured_tensor(line, hit):
    findings = lint(CAPTURED.format(line=line), family="dev")
    assert found(findings, "DEV003") == hit


def test_dev003_quiet_outside_captured_bodies():
    findings = lint("""
        def step(state):
            if state['nb'] > 5:
                return None
            return state
    """, family="dev")
    assert found(findings, "DEV003") == []


@pytest.mark.parametrize("line,hit", [
    ("buf = torch.zeros(len(self.items))", ["torch.zeros"]),
    ("buf = torch.arange(state['bkeys'].shape[1])", ["torch.arange"]),
    ("buf = torch.zeros(8)", []),
])
def test_dev005_sized_constructor_in_a_captured_body(line, hit):
    findings = lint(CAPTURED.format(line=line), family="dev")
    assert found(findings, "DEV005") == hit


def test_dev005_quiet_outside_captured_bodies():
    findings = lint("""
        import torch

        def host(items):
            return torch.zeros(len(items))
    """, family="dev")
    assert found(findings, "DEV005") == []


PLACEMENT = """
    import torch

    def place(t, device):
        a = torch.ones(3).cuda()
        b = t.to("cuda")
        c = torch.zeros(4, device="cuda:0")
        d = t.to(device)
        e = t.to("cpu")
        f = torch.zeros(4, device=torch.device("cuda"))
        return a, b, c, d, e, f
"""


def test_dev007_flags_cuda_placement_outside_cudaenv():
    assert found(lint(PLACEMENT, family="dev"), "DEV007") == sorted([
        ".cuda", ".to(cuda)", "torch.zeros(device=cuda)",
        "torch.zeros(device=cuda)"])


def test_dev007_quiet_in_cudaenv():
    path = "foundationdb_tpu_torch/utils/cudaenv.py"
    assert found(lint(PLACEMENT, path, family="dev"), "DEV007") == []


def test_dev008_flags_global_prngs():
    findings = lint("""
        import numpy as np
        import torch

        def draw():
            np.random.seed(1)
            torch.manual_seed(0)
            return np.random.rand(3), torch.rand(3), torch.randperm(5)
    """, family="dev")
    assert found(findings, "DEV008") == sorted([
        "numpy.random.seed", "numpy.random.rand", "torch.manual_seed",
        "torch.rand", "torch.randperm"])


def test_dev008_quiet_for_seeded_generators():
    findings = lint("""
        import numpy as np
        import torch

        def draw(seed):
            g = torch.Generator().manual_seed(seed)
            rng = np.random.default_rng(seed)
            return rng.random(3), torch.rand(3, generator=g), \\
                torch.randint(0, 9, (4,), generator=g)
    """, family="dev")
    assert found(findings, "DEV008") == []


def test_dev_rules_without_a_torch_counterpart_are_not_registered():
    codes = {r.code for r in flowlint.active_rules("dev")}
    assert codes == {"DEV001", "DEV002", "DEV003", "DEV005", "DEV007",
                     "DEV008"}
    from foundationdb_tpu_torch.analysis import devlint
    for code in ("DEV004", "DEV006"):
        assert code in devlint.__doc__  # says why it has none


# ------------------------------------------------------------ import rules

NEW_MODULES = (
    "bindings", "bindings.fdb_c", "bindings.multiversion",
    "bindings.bindingtester", "analysis", "analysis.__main__",
    "analysis.flowlint", "analysis.rules", "analysis.callgraph",
    "analysis.csource", "analysis.protolint", "analysis.natlint",
    "analysis.devlint", "graft_entry", "native.sanitize", "ops.encode_np")


@pytest.mark.parametrize("name", NEW_MODULES)
def test_new_module_imports_neither_jax_nor_the_jax_package(name):
    code = ("import sys\n"
            f"import foundationdb_tpu_torch.{name}\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'foundationdb_tpu' or "
            "m.startswith('foundationdb_tpu.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    path = PORT / (name.replace(".", "/") + ".py")
    if not path.exists():
        path = PORT / name.replace(".", "/") / "__init__.py"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.split(".")[0] != "foundationdb_tpu", node.module
            assert node.module.split(".")[0] != "jax", node.module
        elif isinstance(node, ast.Import):
            for alias in node.names:
                assert alias.name.split(".")[0] not in (
                    "foundationdb_tpu", "jax"), alias.name
