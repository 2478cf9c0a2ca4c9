"""devlint rules DEV001..DEV008: torch/CUDA discipline for the hot path.

The port's counterpart of the JAX package's devlint. The JAX rules guard
jit, tracing, donation and `device_put`; here each keeps its code where
torch has the same bug class, with the torch shape of it:

  DEV001  a device->host readback (`.item()`/`.tolist()` on a torch value,
          `.cpu()`, `.numpy()` on one, `torch.cuda.synchronize`, a CUDA
          event's or stream's `.synchronize()`) reachable from a
          sim-visible coroutine, interprocedurally — it blocks the event
          loop. The loop's worker-thread offload (`run_blocking`), where
          the resolvers' readbacks run, is exempt.
  DEV002  a CUDA graph capture (`torch.cuda.CUDAGraph`,
          `torch.cuda.make_graphed_callables`, `torch.cuda.graph` in a
          loop) or a step program (`StepGraph`, `ScanGraph`,
          `ShardedStepGraph`) built per call — inside a loop, or never
          kept past the call — instead of cached.
  DEV003  `if`/`while`/`bool()` on a tensor parameter of a body that is
          captured in a graph: the branch is decided once, at capture,
          and every replay takes it.
  DEV005  `torch.zeros/ones/empty/full/arange/...` sized by `len()` or
          `.shape` arithmetic inside a captured body (or a helper it
          calls): the size is baked in at capture.
  DEV007  a tensor placed on a CUDA device (`.cuda()`, `.to("cuda...")`,
          `device="cuda..."`) outside `utils/cudaenv.py`, the choke point
          that honours CONFLICT_DEVICE and raises platform_error where
          there is no card.
  DEV008  module-global PRNG use: numpy's global `np.random.*`,
          `torch.manual_seed`/`torch.seed` (and their CUDA forms), or a
          `torch.rand*`/`randint`/`randperm`/`normal`/`bernoulli`/
          `multinomial` draw without an explicit `generator=`.

Two JAX rules have no counterpart and are not registered: DEV004 (bad
`static_argnums`: torch has no static arguments) and DEV006 (missing
`donate_argnums`: torch has no donation; the fixed-buffer `out=`
discipline of the step graphs is their own, and K4 and K1 write into it).

DEV001 is interprocedural over the PackageContext call graph
(callgraph.py); DEV003 and DEV005 follow the calls made inside a
`with torch.cuda.graph(...)` block. Resolution is conservative, as in
the JAX rules: an attribute call on an arbitrary receiver counts only when
every same-named method in the package shares the property, and
unresolvable calls are assumed fine.
"""

from __future__ import annotations

import ast
from typing import Iterable

from foundationdb_tpu_torch.analysis.callgraph import (FunctionInfo,
                                                       PackageContext)
from foundationdb_tpu_torch.analysis.flowlint import (
    Finding, ModuleContext, Rule, register)

# device->host synchronization points (DEV001)
_ALWAYS_BLOCKING = {"torch.cuda.synchronize"}
_ALWAYS_BLOCKING_METHODS = {"cpu", "synchronize"}
# readbacks only when called on a torch value (numpy shares the names)
_TAINTED_BLOCKING_METHODS = {"item", "tolist", "numpy"}
# graph captures and step programs (DEV002)
_GRAPH_CTORS = {"torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph",
                "torch.cuda.make_graphed_callables"}
_PROGRAM_CLASSES = {"StepGraph", "ScanGraph", "ShardedStepGraph"}
_GRAPH_CAPTURE = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
# sized constructors whose size a capture bakes in (DEV005)
_SIZED_CTORS = {
    "torch.zeros", "torch.ones", "torch.empty", "torch.full",
    "torch.arange", "torch.eye", "torch.linspace", "torch.randperm",
}
# the sanctioned home of CUDA placement (DEV007)
_SANCTIONED_PLACEMENT_MODULE = "foundationdb_tpu_torch/utils/cudaenv.py"
# np.random.* entry points that do NOT share the module-global PRNG (DEV008)
_NP_RANDOM_OK = {
    "numpy.random.RandomState", "numpy.random.default_rng",
    "numpy.random.Generator", "numpy.random.SeedSequence",
    "numpy.random.PCG64", "numpy.random.Philox", "numpy.random.MT19937",
}
_TORCH_GLOBAL_SEEDS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
}
_TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
}


def _origin(mod: ModuleContext, node: ast.AST) -> str | None:
    return mod.resolve_dotted(node)


def _owned(mod: ModuleContext, fn: ast.AST):
    """Nodes whose nearest enclosing def is `fn` (lambda bodies included,
    nested defs excluded)."""
    for node in ast.walk(fn):
        if mod.enclosing_function(node) is fn:
            yield node


def _torch_rooted(mod: ModuleContext, expr: ast.AST) -> bool:
    """Expression contains a name/attribute chain resolving into torch.*."""
    for node in ast.walk(expr):
        if isinstance(node, (ast.Attribute, ast.Name)):
            origin = _origin(mod, node)
            if origin and (origin == "torch" or origin.startswith("torch.")):
                return True
    return False


def _sanctioned_offload(mod: ModuleContext, node: ast.AST) -> bool:
    """Inside an argument handed to `*.run_blocking(...)` — the loop's
    worker-thread offload, where blocking on the device is the point."""
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.Call) \
                and isinstance(anc.func, ast.Attribute) \
                and anc.func.attr == "run_blocking" \
                and not any(node is n for n in ast.walk(anc.func)):
            return True
    return False


def _cuda_device_expr(mod: ModuleContext, node: ast.AST) -> bool:
    """A constant naming a CUDA device ("cuda", "cuda:1") or
    torch.device(<one>)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value == "cuda" or node.value.startswith("cuda:")
    if isinstance(node, ast.Call) and node.args \
            and _origin(mod, node.func) == "torch.device":
        return _cuda_device_expr(mod, node.args[0])
    return False


def cuda_placement(mod: ModuleContext, call: ast.Call) -> str | None:
    """The detail of a call that puts a tensor on a CUDA device (`.cuda()`,
    `.to(<cuda>)`, a torch call with `device=<cuda>`), else None. Shared
    with FLOW006, which flags the same at import time."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == "cuda" \
            and _origin(mod, func) is None:
        return ".cuda"
    if isinstance(func, ast.Attribute) and func.attr == "to" and (
            any(_cuda_device_expr(mod, a) for a in call.args)
            or any(kw.arg == "device" and _cuda_device_expr(mod, kw.value)
                   for kw in call.keywords)):
        return ".to(cuda)"
    origin = _origin(mod, func)
    if origin and origin.startswith("torch.") and any(
            kw.arg == "device" and _cuda_device_expr(mod, kw.value)
            for kw in call.keywords):
        return f"{origin}(device=cuda)"
    return None


def _loop_ancestor(mod: ModuleContext, node: ast.AST) -> bool:
    """A for/while between `node` and its enclosing def."""
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return False
        if isinstance(anc, (ast.For, ast.While, ast.AsyncFor)):
            return True
    return False


# ---------------------------------------------------------------------------
# shared package analysis (computed once, cached on the PackageContext)
# ---------------------------------------------------------------------------

class _DevAnalysis:
    """Call-graph summaries every DEV rule shares: torch taint, the
    blocks-on-host fixpoint, the captured bodies and their reach."""

    def __init__(self, pkg: PackageContext):
        self.pkg = pkg
        self._taint: dict[str, set[str]] = {}
        self._compute_blocking()
        self._compute_captured()

    # ---------------------------------------------------------- torch taint

    def tainted_names(self, fn: FunctionInfo) -> set[str]:
        """Local names assigned from torch-rooted expressions (two
        propagation passes: tainted = torch value until proven host)."""
        cached = self._taint.get(fn.fqname)
        if cached is not None:
            return cached
        tainted: set[str] = set()
        assigns = [n for n in _owned(fn.mod, fn.node)
                   if isinstance(n, ast.Assign) and len(n.targets) == 1
                   and isinstance(n.targets[0], ast.Name)]
        for _ in range(2):
            for n in assigns:
                name = n.targets[0].id
                if name in tainted:
                    continue
                if _torch_rooted(fn.mod, n.value) or any(
                        isinstance(x, ast.Name) and x.id in tainted
                        for x in ast.walk(n.value)):
                    tainted.add(name)
        self._taint[fn.fqname] = tainted
        return tainted

    def _is_tainted_expr(self, fn: FunctionInfo, expr: ast.AST) -> bool:
        if _torch_rooted(fn.mod, expr):
            return True
        tainted = self.tainted_names(fn)
        return any(isinstance(x, ast.Name) and x.id in tainted
                   for x in ast.walk(expr))

    # ------------------------------------------------- blocks-on-host summary

    def _direct_blocks(self, fn: FunctionInfo) -> list[tuple[ast.AST, str]]:
        out: list[tuple[ast.AST, str]] = []
        mod = fn.mod
        for node in _owned(mod, fn.node):
            if not isinstance(node, ast.Call):
                continue
            if _sanctioned_offload(mod, node):
                continue
            func = node.func
            origin = _origin(mod, func)
            if origin in _ALWAYS_BLOCKING:
                out.append((node, origin))
            elif isinstance(func, ast.Attribute) and origin is None:
                if func.attr in _ALWAYS_BLOCKING_METHODS:
                    out.append((node, f".{func.attr}"))
                elif func.attr in _TAINTED_BLOCKING_METHODS \
                        and not node.args \
                        and self._is_tainted_expr(fn, func.value):
                    out.append((node, f".{func.attr}"))
        return out

    def _compute_blocking(self) -> None:
        """Fixpoint: a function blocks on host if it contains a blocking
        primitive, or if every candidate of one of its (non-offloaded)
        calls blocks. Call sites that introduced blocking are recorded for
        DEV001's at-the-call-site reporting."""
        for fn in self.pkg.iter_functions():
            direct = self._direct_blocks(fn)
            fn.summary["direct_blocks"] = direct
            fn.summary["blocks"] = bool(direct)
            fn.summary["blocking_calls"] = []
            fn.summary["calls"] = [
                n for n in _owned(fn.mod, fn.node)
                if isinstance(n, ast.Call)
                and not _sanctioned_offload(fn.mod, n)]
        changed = True
        while changed:
            changed = False
            for fn in self.pkg.iter_functions():
                if fn.summary["blocks"] and not fn.summary["calls"]:
                    continue
                for call in fn.summary["calls"]:
                    cands = self.pkg.resolve_call(fn.mod, call)
                    cands = [c for c in cands if c.fqname != fn.fqname]
                    if not cands or not all(c.summary["blocks"]
                                            for c in cands):
                        continue
                    rec = (call, cands[0].qualname)
                    if rec not in fn.summary["blocking_calls"]:
                        fn.summary["blocking_calls"].append(rec)
                    if not fn.summary["blocks"]:
                        fn.summary["blocks"] = True
                        changed = True

    # ------------------------------------------- captured bodies and reach

    def _capture_candidates(self, mod: ModuleContext,
                            call: ast.Call) -> list[FunctionInfo]:
        """Callees of a call made during a capture: its resolution, and
        for `self.m(...)` every method `m` of the package (a base class's
        capture runs its subclasses' overrides)."""
        cands = list(self.pkg.resolve_call(mod, call))
        func = call.func
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id == "self":
            for info in self.pkg.methods_by_name.get(func.attr, []):
                if info not in cands:
                    cands.append(info)
        return cands

    def _compute_captured(self) -> None:
        """captured: fqname -> its tensor parameters (positional, not
        self; keyword-only ones are configuration), for every function
        called inside a `with torch.cuda.graph(...)` block; reach: those
        and every function they call, transitively."""
        self.captured: dict[str, set[str]] = {}
        for mod in self.pkg.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                if not any(isinstance(item.context_expr, ast.Call)
                           and _origin(mod, item.context_expr.func)
                           in _GRAPH_CAPTURE for item in node.items):
                    continue
                for stmt in node.body:
                    for call in ast.walk(stmt):
                        if not isinstance(call, ast.Call):
                            continue
                        for info in self._capture_candidates(mod, call):
                            args = info.node.args
                            params = {a.arg for a in args.posonlyargs
                                      + args.args} - {"self", "cls"}
                            self.captured[info.fqname] = params
        self.reach: set[str] = set(self.captured)
        frontier = [self.pkg.functions[fq] for fq in self.captured
                    if fq in self.pkg.functions]
        while frontier:
            fn = frontier.pop()
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                for cand in self.pkg.resolve_call(fn.mod, node):
                    if cand.fqname not in self.reach:
                        self.reach.add(cand.fqname)
                        frontier.append(cand)


def _analysis(pkg: PackageContext) -> _DevAnalysis:
    a = pkg.caches.get("devlint")
    if a is None:
        a = _DevAnalysis(pkg)
        pkg.caches["devlint"] = a
    return a


# -------------------------------------------------------------- DEV001

@register
class ImplicitReadbackInActor(Rule):
    code = "DEV001"
    summary = ("device→host readback (.item()/.tolist()/.numpy() on a torch "
               "value, .cpu(), torch.cuda.synchronize, an event's or "
               "stream's .synchronize()) inside a sim-visible coroutine — "
               "blocks the event loop; offload via loop.run_blocking. "
               "Interprocedural: a helper that blocks is flagged at the "
               "coroutine's call site.")

    def check_package(self, pkg: PackageContext) -> Iterable[Finding]:
        _analysis(pkg)
        for fn in pkg.iter_functions():
            if not fn.is_async or not fn.mod.sim_visible:
                continue
            for node, detail in fn.summary.get("direct_blocks", ()):
                yield self.finding(
                    fn.mod, node, detail,
                    f"{detail} synchronizes device→host on the event-loop "
                    f"thread inside coroutine {fn.qualname}; move it into "
                    f"loop.run_blocking(...)")
            for call, callee in fn.summary.get("blocking_calls", ()):
                yield self.finding(
                    fn.mod, call, callee,
                    f"{callee}() blocks on a device→host sync (possibly "
                    f"transitively) and is called from coroutine "
                    f"{fn.qualname} on the event-loop thread; wrap the call "
                    f"in loop.run_blocking(...)")


# -------------------------------------------------------------- DEV002

@register
class GraphBuiltPerCall(Rule):
    code = "DEV002"
    summary = ("CUDA graph or step program (CUDAGraph, make_graphed_"
               "callables, StepGraph/ScanGraph/ShardedStepGraph, a "
               "torch.cuda.graph capture in a loop) built per call — inside "
               "a loop or never kept past the call — re-captures every "
               "batch; cache it (e.g. per shape bucket)")

    @staticmethod
    def _ctor(mod: ModuleContext, call: ast.Call) -> str | None:
        origin = _origin(mod, call.func)
        if origin in _GRAPH_CTORS:
            return origin
        name = (origin.rsplit(".", 1)[-1] if origin
                else call.func.id if isinstance(call.func, ast.Name)
                else None)
        return name if name in _PROGRAM_CLASSES else None

    @staticmethod
    def _kept(mod: ModuleContext, call: ast.Call) -> bool:
        """The built object outlives the call: stored on an attribute or
        in a container, returned, yielded, or handed to another call —
        directly or through the local name it is bound to."""
        parent = mod.parents.get(call)
        if isinstance(parent, (ast.Return, ast.Yield, ast.Call,
                               ast.keyword, ast.Tuple, ast.List, ast.Dict)):
            return True
        if not isinstance(parent, ast.Assign):
            return False
        names = set()
        for tgt in parent.targets:
            if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                return True
            if isinstance(tgt, ast.Name):
                names.add(tgt.id)
        scope = mod.enclosing_function(call)
        if scope is None:
            return True  # module level: built once, at import
        for use in ast.walk(scope):
            if not (isinstance(use, ast.Name) and use.id in names
                    and isinstance(use.ctx, ast.Load)):
                continue
            up = mod.parents.get(use)
            if isinstance(up, (ast.Return, ast.Yield, ast.Call, ast.keyword,
                               ast.Tuple, ast.List, ast.Dict)) \
                    and not (isinstance(up, ast.Call) and up.func is use):
                return True
            if isinstance(up, ast.Assign) and any(
                    isinstance(t, (ast.Attribute, ast.Subscript))
                    for t in up.targets):
                return True
        return False

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if _origin(mod, node.func) in _GRAPH_CAPTURE \
                    and _loop_ancestor(mod, node):
                yield self.finding(
                    mod, node, "torch.cuda.graph",
                    "torch.cuda.graph(...) captures inside a loop — one "
                    "capture per iteration; capture once and replay")
                continue
            what = self._ctor(mod, node)
            if what is None:
                continue
            if _loop_ancestor(mod, node):
                yield self.finding(
                    mod, node, what,
                    f"{what}(...) built inside a loop — one capture per "
                    f"iteration; build it once and replay it")
            elif not self._kept(mod, node):
                yield self.finding(
                    mod, node, what,
                    f"{what}(...) is built and dropped within one call — "
                    f"every call captures anew; keep it (a cache keyed by "
                    f"the shape bucket, or an attribute)")


# -------------------------------------------------------------- DEV003

@register
class CapturedTensorBranch(Rule):
    code = "DEV003"
    summary = ("Python if/while/bool() on a tensor parameter inside a body "
               "captured in a CUDA graph — decided once at capture, baked "
               "into every replay (and a device sync during capture); use "
               "torch.where or keep the decision on the host")

    def check_package(self, pkg: PackageContext) -> Iterable[Finding]:
        ana = _analysis(pkg)
        for fqname, params in ana.captured.items():
            fn = pkg.functions.get(fqname)
            if fn is None or not params:
                continue
            for node in _owned(fn.mod, fn.node):
                tests = []
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    tests.append(node.test)
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id == "bool" and node.args:
                    tests.append(node.args[0])
                for test in tests:
                    hits = sorted({x.id for x in ast.walk(test)
                                   if isinstance(x, ast.Name)
                                   and x.id in params})
                    if hits:
                        yield self.finding(
                            fn.mod, node, hits[0],
                            f"Python branch on tensor parameter "
                            f"'{hits[0]}' inside captured body "
                            f"{fn.qualname}; the capture bakes the branch "
                            f"in — use torch.where (configuration belongs "
                            f"in keyword-only arguments)")


# -------------------------------------------------------------- DEV005

@register
class ShapeDependentConstructor(Rule):
    code = "DEV005"
    summary = ("torch constructor sized by len()/.shape-derived host "
               "arithmetic inside a body captured in a CUDA graph (or a "
               "helper it calls) — the size is baked in at capture; size "
               "it from the program's fixed shapes")

    def check_package(self, pkg: PackageContext) -> Iterable[Finding]:
        ana = _analysis(pkg)
        for fq in sorted(ana.reach):
            fn = pkg.functions.get(fq)
            if fn is None:
                continue
            shape_locals = self._shape_derived_locals(fn)
            for node in _owned(fn.mod, fn.node):
                if not isinstance(node, ast.Call):
                    continue
                origin = _origin(fn.mod, node.func)
                if origin not in _SIZED_CTORS:
                    continue
                exprs = list(node.args) + [kw.value for kw in node.keywords
                                           if kw.arg in (None, "size",
                                                         "end", "start")]
                if any(self._shape_dependent(e, shape_locals)
                       for e in exprs):
                    yield self.finding(
                        fn.mod, node, origin,
                        f"{origin}() sized by host shape arithmetic in "
                        f"{fn.qualname}, which a CUDA graph captures — the "
                        f"size is fixed at capture")

    @staticmethod
    def _shape_derived_locals(fn: FunctionInfo) -> set[str]:
        out: set[str] = set()
        for node in _owned(fn.mod, fn.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and ShapeDependentConstructor._shape_dependent(
                        node.value, out):
                out.add(node.targets[0].id)
        return out

    @staticmethod
    def _shape_dependent(expr: ast.AST, shape_locals: set[str]) -> bool:
        for x in ast.walk(expr):
            if isinstance(x, ast.Attribute) and x.attr == "shape":
                return True
            if isinstance(x, ast.Call) and isinstance(x.func, ast.Name) \
                    and x.func.id == "len":
                return True
            if isinstance(x, ast.Name) and x.id in shape_locals:
                return True
        return False


# -------------------------------------------------------------- DEV007

@register
class RawCudaPlacement(Rule):
    code = "DEV007"
    summary = ("tensor placed on a CUDA device (.cuda(), .to('cuda'), "
               "device='cuda') outside the utils/cudaenv.py choke point — "
               "bypasses CONFLICT_DEVICE and the platform_error raised where "
               "there is no card; use cudaenv.resolve_device/to_device")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        if mod.relpath == _SANCTIONED_PLACEMENT_MODULE:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            detail = cuda_placement(mod, node)
            if detail is not None:
                yield self.finding(
                    mod, node, detail,
                    f"{detail} outside utils/cudaenv.py — CUDA placement "
                    f"must go through its choke point so CONFLICT_DEVICE "
                    f"holds and a card-less host raises platform_error")


# -------------------------------------------------------------- DEV008

@register
class PRNGDiscipline(Rule):
    code = "DEV008"
    summary = ("module-global PRNG use: numpy's np.random.*, torch's global "
               "seed (torch.manual_seed and kin), or a torch random draw "
               "without an explicit generator= — cross-instance coupling, "
               "and seed replay breaks")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            origin = _origin(mod, node.func)
            if not origin:
                continue
            if origin.startswith("numpy.random.") \
                    and origin not in _NP_RANDOM_OK:
                yield self.finding(
                    mod, node, origin,
                    f"{origin}() mutates/draws from numpy's module-global "
                    f"PRNG — seed a local RandomState/default_rng instead "
                    f"(global state couples every engine instance and "
                    f"breaks seed replay)")
            elif origin in _TORCH_GLOBAL_SEEDS:
                yield self.finding(
                    mod, node, origin,
                    f"{origin}() seeds torch's process-global generator — "
                    f"make a torch.Generator and pass it as generator=")
            elif origin in _TORCH_DRAWS and not any(
                    kw.arg == "generator" for kw in node.keywords):
                yield self.finding(
                    mod, node, origin,
                    f"{origin}() draws from torch's process-global "
                    f"generator — pass generator=<a seeded "
                    f"torch.Generator>")
