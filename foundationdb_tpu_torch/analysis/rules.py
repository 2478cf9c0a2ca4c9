"""flowlint rules FLOW001..FLOW007: the actor-discipline contract.

Each rule encodes one bug class the deterministic simulator cannot tolerate
(docs/flowlint.md has the narrative; ADVICE round 5 found FLOW002/FLOW003
instances by hand before this existed). Rules are static approximations:
they may over-flag (baseline or `# flowlint: ignore[...]` the provable
false positives) but are designed never to miss the exemplar patterns —
tests/test_flowlint.py pins both directions per rule.
"""

from __future__ import annotations

import ast
from typing import Iterable

from foundationdb_tpu_torch.analysis.flowlint import (
    Finding, ModuleContext, Rule, register)

# -------------------------------------------------------------- FLOW001

# Dotted origins that read wall-clock time or OS entropy. Sim-visible
# coroutines must use loop.now()/loop.delay() and DeterministicRandom
# instead — one stray call makes a (seed, spec) replay diverge.
_NONDET_EXACT = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.sleep",
    "os.urandom", "uuid.uuid4", "uuid.uuid1",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}
_NONDET_PREFIXES = ("random.", "secrets.")


@register
class NondeterminismInSimCode(Rule):
    code = "FLOW001"
    summary = ("wall clock / OS randomness in a sim-visible coroutine "
               "(core/, server/, net/) — use the sim clock or "
               "DeterministicRandom")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        if not mod.sim_visible:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            origin = mod.resolve_dotted(node.func)
            if origin is None:
                continue
            if origin not in _NONDET_EXACT and \
                    not origin.startswith(_NONDET_PREFIXES):
                continue
            if not any(isinstance(a, ast.AsyncFunctionDef)
                       for a in mod.ancestors(node)):
                continue  # only coroutines are sim-scheduled
            yield self.finding(
                mod, node, origin,
                f"nondeterministic call {origin}() inside a sim-visible "
                f"coroutine; use the event-loop clock / DeterministicRandom")


# -------------------------------------------------------------- FLOW002

_SETTLE_ATTRS = {"set", "send", "trigger"}


@register
class UnprotectedGateSettle(Rule):
    code = "FLOW002"
    summary = ("gate settle (Promise.send / NotifiedVersion.set / "
               "AsyncTrigger.trigger) reachable after an await but not "
               "protected by try/finally — cancellation wedges waiters")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if isinstance(fn, ast.AsyncFunctionDef):
                yield from self._check_coroutine(mod, fn)

    def _check_coroutine(self, mod: ModuleContext,
                         fn: ast.AsyncFunctionDef) -> Iterable[Finding]:
        awaits = [n for n in ast.walk(fn) if isinstance(n, ast.Await)
                  and mod.enclosing_function(n) is fn]
        if not awaits:
            return

        def pos(n):
            return (n.lineno, n.col_offset)

        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SETTLE_ATTRS
                    and len(node.args) <= 1 and not node.keywords
                    and self._self_rooted(node.func.value)):
                # Only instance-state gates (self.version, self._drained_seq,
                # self._wake): a reply Promise arrives as a parameter and the
                # transport breaks owed replies when the process dies, so a
                # skipped reply.send() cannot wedge anyone.
                continue
            if mod.enclosing_function(node) is not fn or any(
                    isinstance(a, ast.Lambda) for a in mod.ancestors(node)):
                continue  # inside a nested callback: runs at its own time
            prior = [a for a in awaits if pos(a) < pos(node)]
            if not prior:
                continue  # cancellation lands at awaits; none precede it
            if self._protected(mod, node, prior):
                continue
            target = ast.unparse(node.func)
            yield self.finding(
                mod, node, target,
                f"{target}() runs after an await but outside any "
                f"try/finally covering that await — a cancellation at the "
                f"await skips the settle and wedges every waiter")

    @staticmethod
    def _self_rooted(node: ast.AST) -> bool:
        cur = node
        while isinstance(cur, ast.Attribute):
            cur = cur.value
        return isinstance(cur, ast.Name) and cur.id == "self"

    @staticmethod
    def _protected(mod: ModuleContext, settle: ast.Call,
                   prior_awaits: list[ast.Await]) -> bool:
        """True iff the settle sits in the finalbody of a Try that encloses
        every await that can execute before it (so no cancellation point
        can skip the finally)."""
        for anc in mod.ancestors(settle):
            if not isinstance(anc, ast.Try) or not anc.finalbody:
                continue
            in_final = any(settle is d or settle in ast.walk(d)
                           for d in anc.finalbody)
            if not in_final:
                continue
            covered = set(ast.walk(anc))
            if all(a in covered for a in prior_awaits):
                return True
        return False


# -------------------------------------------------------------- FLOW003

_MUTATORS = {"append", "extend", "insert", "remove", "pop", "clear",
             "update", "add", "discard", "popleft", "appendleft"}
_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition"}
_XTHREAD_MARKERS = {"threading.Event", "threading.Condition"}


@register
class UnlockedSharedMutation(Rule):
    code = "FLOW003"
    summary = ("instance attribute mutated across threads without "
               "consistently holding the class's threading.Lock")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        if not any(o == "threading" or o.startswith("threading.")
                   for o in mod.import_aliases.values()):
            return  # module does not advertise thread-safety
        for cls in ast.walk(mod.tree):
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(mod, cls)

    def _check_class(self, mod: ModuleContext,
                     cls: ast.ClassDef) -> Iterable[Finding]:
        lock_attrs: set[str] = set()
        has_xthread_marker = False
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                origin = mod.resolve_dotted(node.value.func)
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        if origin in _LOCK_CTORS:
                            lock_attrs.add(t.attr)
                        if origin in _XTHREAD_MARKERS:
                            has_xthread_marker = True

        # (attr) -> {"locked": [...nodes], "unlocked": [...nodes]},
        # plus the set of methods each attr is mutated from
        sites: dict[str, dict[str, list]] = {}
        methods: dict[str, set[str]] = {}
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if meth.name == "__init__":
                continue  # construction happens-before publication
            for attr, node in self._mutations(meth):
                if attr in lock_attrs:
                    continue
                held = self._under_lock(mod, node, lock_attrs)
                d = sites.setdefault(attr, {"locked": [], "unlocked": []})
                d["locked" if held else "unlocked"].append(node)
                methods.setdefault(attr, set()).add(meth.name)

        for attr, d in sorted(sites.items()):
            if lock_attrs:
                if d["locked"] and d["unlocked"]:
                    for node in d["unlocked"]:
                        yield self.finding(
                            mod, node, attr,
                            f"self.{attr} is mutated both under and outside "
                            f"the class lock; this unlocked site races the "
                            f"locked ones")
            elif has_xthread_marker and len(methods.get(attr, ())) >= 2:
                for node in d["unlocked"]:
                    yield self.finding(
                        mod, node, attr,
                        f"self.{attr} is mutated from multiple methods of a "
                        f"cross-thread class (threading.Event present) with "
                        f"no lock at all")

    @staticmethod
    def _mutations(meth: ast.AST):
        """(attr, node) for every `self.X = ...` / `self.X op= ...` /
        `self.X.append(...)`-style mutation inside `meth`."""
        for node in ast.walk(meth):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    yield t.attr, node
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS \
                    and isinstance(node.func.value, ast.Attribute) \
                    and isinstance(node.func.value.value, ast.Name) \
                    and node.func.value.value.id == "self":
                yield node.func.value.attr, node

    @staticmethod
    def _under_lock(mod: ModuleContext, node: ast.AST,
                    lock_attrs: set[str]) -> bool:
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Attribute) \
                            and isinstance(ctx.value, ast.Name) \
                            and ctx.value.id == "self" \
                            and ctx.attr in lock_attrs:
                        return True
        return False


# -------------------------------------------------------------- FLOW004

@register
class SwallowedCancellation(Rule):
    code = "FLOW004"
    summary = ("bare except / except BaseException without re-raise inside "
               "an actor — swallows operation_cancelled, so kills cannot "
               "reap the actor")

    _BROAD = {"BaseException", "CancelledError"}

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for t in ast.walk(fn):
                if isinstance(t, ast.Try) and mod.enclosing_function(t) is fn:
                    yield from self._check_try(mod, t)

    def _check_try(self, mod: ModuleContext, t: ast.Try) -> Iterable[Finding]:
        earlier_reraises = False
        for h in t.handlers:
            names = self._handler_names(h)
            has_raise = any(isinstance(n, ast.Raise) for n in ast.walk(h))
            if h.type is None:
                yield self.finding(
                    mod, h, "bare-except",
                    "bare `except:` in an actor catches cancellation; name "
                    "the errors, or re-raise operation_cancelled")
            elif names & self._BROAD and not has_raise \
                    and not earlier_reraises:
                caught = " | ".join(sorted(names & self._BROAD))
                yield self.finding(
                    mod, h, caught,
                    f"`except {caught}` without re-raise swallows "
                    f"cancellation — kills can no longer reap this actor")
            earlier_reraises = earlier_reraises or has_raise

    @staticmethod
    def _handler_names(h: ast.ExceptHandler) -> set[str]:
        nodes = []
        if isinstance(h.type, ast.Tuple):
            nodes = h.type.elts
        elif h.type is not None:
            nodes = [h.type]
        names = set()
        for n in nodes:
            if isinstance(n, ast.Name):
                names.add(n.id)
            elif isinstance(n, ast.Attribute):
                names.add(n.attr)
        return names


# -------------------------------------------------------------- FLOW005

_GATE_FUTURES = {"when_at_least", "on_trigger", "on_change"}


@register
class DroppedCoroutineOrFuture(Rule):
    code = "FLOW005"
    summary = ("coroutine called but never awaited / gate future dropped "
               "on the floor")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        # Only module-level async defs and class-level async methods: a
        # nested `async def run()` is function-local (always handed straight
        # to spawn/submit) and its common name would collide with unrelated
        # sync methods across the module.
        top_async: set[str] = set()
        method_async: set[str] = set()
        for parent in ast.walk(mod.tree):
            if isinstance(parent, ast.Module):
                top_async |= {n.name for n in parent.body
                              if isinstance(n, ast.AsyncFunctionDef)}
            elif isinstance(parent, ast.ClassDef):
                method_async |= {n.name for n in parent.body
                                 if isinstance(n, ast.AsyncFunctionDef)}
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)):
                continue
            call = node.value
            name = None
            if isinstance(call.func, ast.Name):
                if call.func.id in top_async:
                    name = call.func.id
            elif isinstance(call.func, ast.Attribute):
                # attribute matches only on self.<async method>: matching
                # arbitrary receivers by name alone would flag every
                # `tr.set(...)` whenever some class has an async set()
                if isinstance(call.func.value, ast.Name) \
                        and call.func.value.id == "self" \
                        and call.func.attr in (method_async | top_async):
                    name = call.func.attr
            if name is not None:
                yield self.finding(
                    mod, call, name,
                    f"{name}() is an async def but the coroutine is "
                    f"discarded — await it or hand it to spawn()")
            elif isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _GATE_FUTURES:
                yield self.finding(
                    mod, call, call.func.attr,
                    f"{call.func.attr}() returns a Future that is dropped "
                    f"on the floor — await it or register a callback")


# -------------------------------------------------------------- FLOW006

# kernel and extension libraries built or loaded: the port's own builders
# (ops/kernels.py, the C extension's loader, whose `mod` attribute builds
# on first touch) and the generic loaders
_LIBRARY_LOADERS = {
    "ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary",
    "torch.ops.load_library", "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline",
    "foundationdb_tpu_torch.ops.kernels.build",
    "foundationdb_tpu_torch.ops.kernels.library",
    "foundationdb_tpu_torch.native.build",
    "foundationdb_tpu_torch.native.load",
    "foundationdb_tpu_torch.native.available",
}
_LIBRARY_ATTRS = {"foundationdb_tpu_torch.native.mod"}


@register
class DeviceEvalAtImport(Rule):
    code = "FLOW006"
    summary = ("CUDA touched at module import time — a torch.cuda.* call, a "
               "tensor built on a CUDA device, or a kernel/extension library "
               "built or loaded: every importer pays for it (and a host "
               "without a card fails to import)")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        from foundationdb_tpu_torch.analysis.devlint import cuda_placement
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.Call, ast.Attribute)):
                continue
            if mod.enclosing_function(node) is not None:
                continue  # runs at call time, not import time
            if isinstance(node, ast.Attribute):
                origin = mod.resolve_dotted(node)
                if origin in _LIBRARY_ATTRS and not isinstance(
                        mod.parents.get(node), ast.Attribute):
                    yield self.finding(
                        mod, node, origin,
                        f"{origin} read at import time builds and loads the "
                        f"C extension for every importer; read it inside a "
                        f"function")
                continue
            origin = mod.resolve_dotted(node.func)
            if origin and (origin.startswith("torch.cuda.")
                           or origin in _LIBRARY_LOADERS):
                detail = origin
            else:
                detail = cuda_placement(mod, node)
            if detail is not None:
                yield self.finding(
                    mod, node, detail,
                    f"{detail} evaluated at import time touches CUDA (or "
                    f"builds a library) for every importer; do it lazily "
                    f"inside a function (see ops/kernels.py library())")


# -------------------------------------------------------------- FLOW007

def _trace_event_root(call: ast.Call) -> ast.Call | None:
    """Innermost Call of a fluent chain when it constructs a TraceEvent
    (`TraceEvent(...).detail(...).error(...)`); None otherwise."""
    node = call
    while isinstance(node.func, ast.Attribute) \
            and isinstance(node.func.value, ast.Call):
        node = node.func.value
    if isinstance(node.func, ast.Name) and node.func.id == "TraceEvent":
        return node
    return None


@register
class UnloggedTraceEvent(Rule):
    code = "FLOW007"
    summary = ("TraceEvent built but never .log()'d — the event silently "
               "vanishes (the reference logs from the destructor; ours "
               "only on an explicit .log())")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            # case 1: a fluent chain as a bare expression statement whose
            # outermost call is not .log()
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                call = node.value
                if _trace_event_root(call) is None:
                    continue
                last = call.func.attr \
                    if isinstance(call.func, ast.Attribute) else None
                if last != "log":
                    yield self.finding(
                        mod, call, "TraceEvent",
                        "TraceEvent chain discarded without .log() — "
                        "nothing is emitted")
            # case 2: bound to a name that is never .log()'d in scope
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                tgt = node.targets[0]
                if _trace_event_root(node.value) is None:
                    continue
                outer = node.value.func
                if isinstance(outer, ast.Attribute) and outer.attr == "log":
                    continue  # `x = TraceEvent(...).log()` already emitted
                scope = mod.enclosing_function(node) or mod.tree
                logged = escaped = False
                for use in ast.walk(scope):
                    if not (isinstance(use, ast.Name) and use.id == tgt.id
                            and isinstance(use.ctx, ast.Load)):
                        continue
                    parent = mod.parents.get(use)
                    if isinstance(parent, ast.Attribute):
                        if parent.attr == "log":
                            logged = True
                        continue  # .detail()/.error() keep the chain alive
                    escaped = True  # returned / passed along: out of scope
                if not logged and not escaped:
                    yield self.finding(
                        mod, node.value, tgt.id,
                        f"TraceEvent bound to {tgt.id!r} but never "
                        f".log()'d in this scope — nothing is emitted")
