"""flowlint: AST-based actor-discipline & determinism analyzer.

The port's copy of the JAX package's analyzer (foundationdb_tpu/analysis/),
pointed at this package. The deterministic simulator (core/sim.py, after
fdbrpc/sim2.actor.cpp) only delivers its replay guarantee if no actor code
smuggles in wall-clock time, OS randomness, or settle-skipping control
flow. This engine walks Python sources, runs a registry of rules over each
module's AST — plus a package-level pass for interprocedural rules — and
diffs the findings against a checked-in baseline of documented
grandfathered violations, so every new violation fails tier-1 the moment
it is written.

Four rule families ride the engine, all gated over this package by
tests/test_torch_analysis.py:
  - flow (rules.py, FLOW001..FLOW007): actor discipline & determinism;
    FLOW006 is the torch rule (no CUDA touched at import time).
  - dev (devlint.py, DEV001..DEV008): torch/CUDA discipline on the hot
    path (readbacks on the loop thread, graphs captured per call, CUDA
    placement outside its choke points, PRNG discipline).
  - proto (protolint.py, PROTO001..PROTO008): protocol conformance on the
    RPC/wire layer (token routing, reply-on-all-paths, Python<->C schema
    parity).
  - nat (natlint.py, NAT001..NAT007): native C-extension discipline over
    native/fdb_native.c itself (refcount balance on goto ladders, bounds
    checks, decoded-count validation), via the csource.py C front-end;
    alongside the ASan/UBSan fuzz harness (native/sanitize.py).

Engine pieces:
  - Finding: one violation, with a line-number-independent identity key
    (rule, path, enclosing symbol, detail) so baselines survive edits.
  - ModuleContext: parsed module + parent links + qualname/suppression
    helpers shared by all rules.
  - PackageContext (callgraph.py): whole-target-set parse + call-site
    resolution, for rules whose evidence crosses module boundaries.
  - Rule: base class; rules self-register via @register and may implement
    check() (per module), check_package() (whole package), or both.
  - analyze_source / analyze_paths: run the registry over snippets or trees.
  - baseline load/apply/write: the allowlist workflow
    (`python -m foundationdb_tpu_torch.analysis --update-baseline`), with a
    fuzzy second matching tier so renaming an enclosing function does not
    orphan its documented entries.

Inline suppression: a line containing `# flowlint: ignore[FLOW00X]` (or
`# devlint: ignore[DEV00X]`, `# protolint: ignore[PROTO00X]`,
`ignore[all]`, or a comma-separated code list) is exempt — for the rare spot where the rule's static approximation
is provably wrong and a baseline entry would be noise.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Iterable, Iterator

PACKAGE_NAME = "foundationdb_tpu_torch"

# Subpackages whose coroutines are sim-visible: they run under the
# deterministic loop and must draw time/randomness from it. testing/ hosts
# the simulated-cluster workloads — sim-visible code in every sense.
SIM_VISIBLE = ("core", "server", "net", "testing")

FAMILIES = ("flow", "dev", "proto", "nat")


def rule_family(code: str) -> str:
    """Family of a rule code: DEV* -> "dev", PROTO* -> "proto", NAT* ->
    "nat", everything else -> "flow"."""
    if code.startswith("DEV"):
        return "dev"
    if code.startswith("PROTO"):
        return "proto"
    if code.startswith("NAT"):
        return "nat"
    return "flow"


@dataclass(frozen=True)
class Finding:
    rule: str       # "FLOW001"
    path: str       # package-rooted posix path, e.g. foundationdb_tpu_torch/server/resolver.py
    line: int
    symbol: str     # enclosing qualname ("Resolver._drain_group") or "<module>"
    detail: str     # stable token for baseline identity (offending name/attr)
    message: str

    @property
    def key(self) -> str:
        """Line-number-independent identity used for baseline matching."""
        return f"{self.rule}:{self.path}:{self.symbol}:{self.detail}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "symbol": self.symbol, "detail": self.detail,
                "message": self.message}


class ModuleContext:
    """One parsed module plus the derived maps every rule needs."""

    def __init__(self, relpath: str, source: str, tree: ast.Module):
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    # -- path classification --

    @property
    def subpackage(self) -> str:
        """First directory under the package root ("server", "core", ...)."""
        parts = self.relpath.split("/")
        if parts and parts[0] == PACKAGE_NAME:
            parts = parts[1:]
        return parts[0] if len(parts) > 1 else ""

    @property
    def sim_visible(self) -> bool:
        return self.subpackage in SIM_VISIBLE

    # -- tree helpers --

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        """Nearest enclosing def/async def, or None at module/class level."""
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def qualname(self, node: ast.AST) -> str:
        names = [anc.name for anc in self.ancestors(node)
                 if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef))]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.insert(0, node.name)
        return ".".join(reversed(names)) or "<module>"

    def suppressed(self, line: int, rule: str) -> bool:
        """`# flowlint: ignore[FLOW001]` / `# devlint: ignore[DEV007]` /
        `ignore[FLOW001,FLOW002]` / `ignore[all]`. Either tag word accepts
        either family's codes — the split exists for greppability, not
        scoping."""
        if not 1 <= line <= len(self.lines):
            return False
        text = self.lines[line - 1]
        for marker in ("flowlint:", "devlint:", "protolint:"):
            if marker not in text:
                continue
            tag = text.split(marker, 1)[1]
            m = re.search(r"ignore\[([^\]]*)\]", tag)
            if m is None:
                continue
            codes = {c.strip() for c in m.group(1).split(",")}
            if "all" in codes or rule in codes:
                return True
        return False

    # -- import resolution (aliases -> dotted module names) --

    @property
    def import_aliases(self) -> dict[str, str]:
        """Maps local name -> dotted origin: `import time` -> {"time":
        "time"}; `import jax.numpy as jnp` -> {"jnp": "jax.numpy"};
        `from time import sleep` -> {"sleep": "time.sleep"}."""
        cached = getattr(self, "_aliases", None)
        if cached is not None:
            return cached
        aliases: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
                    if a.asname is None and "." in a.name:
                        # `import jax.numpy` binds "jax" but makes the
                        # submodule reachable as jax.numpy — record the root
                        aliases[a.name.split(".")[0]] = a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        self._aliases = aliases
        return aliases

    def resolve_dotted(self, node: ast.AST) -> str | None:
        """Dotted origin of a Name/Attribute chain, through import aliases:
        with `import time as t`, `t.sleep` resolves to "time.sleep"."""
        parts: list[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        origin = self.import_aliases.get(cur.id)
        if origin is None:
            return None
        parts.append(origin)
        return ".".join(reversed(parts))


class Rule:
    """One check. Subclasses set `code`/`summary` and implement check()
    (per-module) and/or check_package() (whole-target-set, for rules whose
    evidence crosses module boundaries)."""

    code = "FLOW000"
    summary = ""

    @property
    def family(self) -> str:
        return rule_family(self.code)

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        return ()

    def check_package(self, pkg) -> Iterable[Finding]:
        """pkg is a callgraph.PackageContext over every analyzed module."""
        return ()

    def finding(self, mod: ModuleContext, node: ast.AST, detail: str,
                message: str) -> Finding:
        return Finding(rule=self.code, path=mod.relpath,
                       line=getattr(node, "lineno", 0),
                       symbol=mod.qualname(node), detail=detail,
                       message=message)


_REGISTRY: list[type[Rule]] = []


def register(cls: type[Rule]) -> type[Rule]:
    _REGISTRY.append(cls)
    return cls


def active_rules(family: str = "all") -> list[Rule]:
    # importing the rule modules populates the registry
    from foundationdb_tpu_torch.analysis import (  # noqa: F401
        devlint, natlint, protolint, rules)
    out = [cls() for cls in sorted(_REGISTRY, key=lambda c: c.code)]
    if family != "all":
        out = [r for r in out if r.family == family]
    return out


# ---------------------------------------------------------------- running

def _run_rules(mods: list[ModuleContext],
               rules: list[Rule]) -> list[Finding]:
    """Per-module checks + one package pass, suppression-filtered."""
    from foundationdb_tpu_torch.analysis.callgraph import PackageContext
    pkg = PackageContext(mods)
    by_path = {m.relpath: m for m in mods}
    out: list[Finding] = []
    for rule in rules:
        found: list[Finding] = []
        for mod in mods:
            found.extend(rule.check(mod))
        found.extend(rule.check_package(pkg))
        for f in found:
            owner = by_path.get(f.path)
            if owner is None or not owner.suppressed(f.line, f.rule):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def analyze_source(source: str, relpath: str,
                   rules: list[Rule] | None = None) -> list[Finding]:
    """Run the registry over one module's source (tests feed snippets here;
    `relpath` decides path-scoped rules like FLOW001). Package rules see a
    one-module package."""
    tree = ast.parse(source)
    mod = ModuleContext(relpath, source, tree)
    return _run_rules([mod], rules if rules is not None else active_rules())


def canonical_relpath(abspath: str) -> str:
    """Package-rooted path for baseline stability: the same file keys
    identically no matter what directory the analyzer was launched from.
    Repo-level `scripts/` files anchor at the scripts dir the same way."""
    parts = os.path.abspath(abspath).replace(os.sep, "/").split("/")
    if PACKAGE_NAME in parts:
        return "/".join(parts[parts.index(PACKAGE_NAME):])
    if "scripts" in parts:
        return "/".join(parts[parts.index("scripts"):])
    return os.path.relpath(abspath).replace(os.sep, "/")


def iter_py_files(path: str) -> Iterator[str]:
    if os.path.isfile(path):
        yield path
        return
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs
                         if d not in ("__pycache__", ".git"))
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def analyze_paths(paths: list[str],
                  rules: list[Rule] | None = None) -> list[Finding]:
    """Parse every target file first, then run the registry over the whole
    set as ONE package — interprocedural rules see cross-module calls."""
    rules = rules if rules is not None else active_rules()
    mods: list[ModuleContext] = []
    out: list[Finding] = []
    seen: set[str] = set()
    for path in paths:
        for file in iter_py_files(path):
            relpath = canonical_relpath(file)
            if relpath in seen:
                continue
            seen.add(relpath)
            with open(file, encoding="utf-8") as f:
                source = f.read()
            try:
                mods.append(ModuleContext(relpath, source,
                                          ast.parse(source)))
            except SyntaxError as e:
                out.append(Finding(
                    rule="FLOW000", path=relpath,
                    line=e.lineno or 0, symbol="<module>",
                    detail="syntax-error",
                    message=f"could not parse: {e.msg}"))
    out.extend(_run_rules(mods, rules))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


# ---------------------------------------------------------------- baseline

@dataclass
class Baseline:
    """Allowlist of grandfathered findings. Every entry must carry a
    non-empty `reason` documenting why it is tolerated — update-baseline
    inserts a FIXME placeholder that the tier-1 test rejects."""

    path: str | None = None
    entries: list[dict] = field(default_factory=list)

    @property
    def keys(self) -> set[str]:
        return {_entry_key(e) for e in self.entries}


def _entry_key(entry: dict) -> str:
    return (f"{entry['rule']}:{entry['path']}:{entry['symbol']}:"
            f"{entry['detail']}")


def load_baseline(path: str | None) -> Baseline:
    if path is None or not os.path.exists(path):
        return Baseline(path=path)
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return Baseline(path=path, entries=list(data.get("entries", [])))


def _fuzzy_key(rule: str, path: str, detail: str) -> str:
    return f"{rule}:{path}:{detail}"


def apply_baseline(findings: list[Finding], baseline: Baseline,
                   families: set[str] | None = None,
                   ) -> tuple[list[Finding], list[dict]]:
    """-> (new findings not in the baseline, stale entries matching nothing).

    Matching is two-tier: exact identity key first, then (rule, path,
    detail) — so renaming the enclosing function (or moving the line) does
    not orphan a documented entry. The fuzzy tier is count-aware: two
    findings cannot both consume one entry.

    `families` restricts which baseline entries participate: a
    `--family flow` run must neither report the dev entries stale nor vice
    versa.
    """
    entries = [e for e in baseline.entries
               if families is None or rule_family(e["rule"]) in families]
    exact = {_entry_key(e) for e in entries}
    live = {f.key for f in findings}
    matched: set[int] = set()  # indexes of entries consumed (exact or fuzzy)
    for i, e in enumerate(entries):
        if _entry_key(e) in live:
            matched.add(i)
    # fuzzy tier: unmatched findings vs unmatched entries by (rule, path,
    # detail), greedy one-to-one
    fuzzy_pool: dict[str, list[int]] = {}
    for i, e in enumerate(entries):
        if i not in matched:
            fuzzy_pool.setdefault(
                _fuzzy_key(e["rule"], e["path"], e["detail"]), []).append(i)
    new: list[Finding] = []
    for f in findings:
        if f.key in exact:
            continue
        pool = fuzzy_pool.get(_fuzzy_key(f.rule, f.path, f.detail))
        if pool:
            matched.add(pool.pop(0))
            continue
        new.append(f)
    stale = [e for i, e in enumerate(entries) if i not in matched]
    return new, stale


def write_baseline(path: str, findings: list[Finding], old: Baseline,
                   families: set[str] | None = None) -> Baseline:
    """Regenerate the baseline from current findings, carrying forward the
    documented reasons of entries that still match (exactly, or fuzzily by
    (rule, path, detail) after a rename). Entries of families NOT in this
    run are preserved verbatim — a flow-only update cannot drop dev
    grandfathers."""
    reasons = {_entry_key(e): e.get("reason", "") for e in old.entries}
    fuzzy_reasons = {
        _fuzzy_key(e["rule"], e["path"], e["detail"]): e.get("reason", "")
        for e in old.entries}
    entries, seen = [], set()
    for e in old.entries:
        if families is not None and rule_family(e["rule"]) not in families:
            entries.append(dict(e))
            seen.add(_entry_key(e))
    for f in findings:
        if families is not None and rule_family(f.rule) not in families:
            continue
        if f.key in seen:
            continue
        seen.add(f.key)
        entries.append({
            "rule": f.rule, "path": f.path, "symbol": f.symbol,
            "detail": f.detail,
            "reason": reasons.get(f.key)
            or fuzzy_reasons.get(_fuzzy_key(f.rule, f.path, f.detail))
            or "FIXME: document why this is safe",
        })
    entries.sort(key=lambda e: (e["rule"], e["path"], e["symbol"],
                                e["detail"]))
    data = {"version": 1, "entries": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return Baseline(path=path, entries=entries)


# ---------------------------------------------------------------- output

def format_text(findings: list[Finding]) -> str:
    return "\n".join(f"{f.path}:{f.line}: {f.rule} [{f.symbol}] {f.message}"
                     for f in findings)


def format_json(findings: list[Finding]) -> str:
    return json.dumps({"findings": [f.as_dict() for f in findings]},
                      indent=2, sort_keys=True)


def format_github(findings: list[Finding]) -> str:
    """GitHub Actions workflow annotations: one ::error line per finding,
    rendered inline on the PR diff by the runner."""
    out = []
    for f in findings:
        msg = f.message.replace("%", "%25").replace("\n", "%0A")
        out.append(f"::error file={f.path},line={f.line},"
                   f"title={f.rule} [{f.symbol}]::{msg}")
    return "\n".join(out)


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "flowlint_baseline.json")


def default_target() -> str:
    """The package directory itself (analyze everything)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_targets() -> list[str]:
    """The package dir alone. The repo's scripts/ belong to the JAX
    package (its own analyzer covers them), and the repo-level
    chip_smoke.py is left out: it is a driver of the card, not a module of
    the package, and it blocks on the device by design (it reads every
    kernel's output back to hold it against its plain version)."""
    return [default_target()]
