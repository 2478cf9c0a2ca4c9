"""Package-level call graph for interprocedural lint rules.

flowlint's original engine was strictly per-module: every rule saw one
ModuleContext at a time, so a coroutine that called a blocking helper
defined two modules away was invisible. PackageContext parses the whole
target set once, indexes every function/method, and resolves call sites
through import aliases — enough for per-function summaries (devlint's
blocks-on-host propagation, jit-target reachability) to cross module
boundaries.

Resolution is deliberately conservative:

  - `f(...)` resolves to the module-level `f` in the same module, to the
    function a `from pkg.mod import f` alias names, or to `Cls.__init__`
    when `f` is a class defined/imported in the module.
  - `self.m(...)` resolves to method `m` of the enclosing class when it
    defines one.
  - `obj.m(...)` on an arbitrary receiver resolves to EVERY method named
    `m` across the package ("duck candidates"). Callers that need
    soundness-against-false-positives must require that *all* candidates
    share the property they propagate (see devlint's blocking fixpoint).

Unresolved calls return no candidates; rules treat that as "assume fine"
— the engine under-approximates rather than spray false positives.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from foundationdb_tpu_torch.analysis.flowlint import ModuleContext, PACKAGE_NAME


@dataclass
class FunctionInfo:
    """One def/async def anywhere in the package, plus room for the
    per-function summaries interprocedural rules compute over it."""

    fqname: str                 # "<relpath>::<qualname>"
    relpath: str
    qualname: str
    node: ast.AST               # FunctionDef | AsyncFunctionDef
    mod: ModuleContext
    is_async: bool
    class_name: str | None      # enclosing class for methods, else None
    summary: dict = field(default_factory=dict)  # rule-family scratch space

    @property
    def name(self) -> str:
        return self.node.name


def _dotted_module_name(relpath: str) -> str | None:
    """foundationdb_tpu_torch/ops/conflict.py -> foundationdb_tpu_torch.ops.conflict;
    paths outside the package (scripts/...) have no importable name."""
    if not relpath.startswith(PACKAGE_NAME + "/"):
        return None
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


class PackageContext:
    """All ModuleContexts of one analysis run + cross-module indexes."""

    def __init__(self, modules: list[ModuleContext]):
        self.modules = list(modules)
        self.by_relpath: dict[str, ModuleContext] = {
            m.relpath: m for m in self.modules}
        self.by_dotted: dict[str, ModuleContext] = {}
        for m in self.modules:
            dn = _dotted_module_name(m.relpath)
            if dn is not None:
                self.by_dotted[dn] = m

        # (relpath, name) -> FunctionInfo for module-level functions
        self.top_level: dict[tuple[str, str], FunctionInfo] = {}
        # (relpath, ClassName) -> {method name -> FunctionInfo}
        self.classes: dict[tuple[str, str], dict[str, FunctionInfo]] = {}
        # method name -> [FunctionInfo ...] across every class (duck index)
        self.methods_by_name: dict[str, list[FunctionInfo]] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self._index()
        # rule families stash shared computed state here (e.g. devlint's
        # blocking fixpoint) so eight rules don't redo one analysis
        self.caches: dict[str, object] = {}

    # ---------------------------------------------------------------- build

    def _index(self) -> None:
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                qual = mod.qualname(node)
                info = FunctionInfo(
                    fqname=f"{mod.relpath}::{qual}",
                    relpath=mod.relpath, qualname=qual, node=node, mod=mod,
                    is_async=isinstance(node, ast.AsyncFunctionDef),
                    class_name=self._enclosing_class_name(mod, node))
                self.functions[info.fqname] = info
                parent = mod.parents.get(node)
                if isinstance(parent, ast.Module):
                    self.top_level[(mod.relpath, node.name)] = info
                elif isinstance(parent, ast.ClassDef):
                    cls = self.classes.setdefault(
                        (mod.relpath, parent.name), {})
                    cls[node.name] = info
                    if not node.name.startswith("__"):
                        self.methods_by_name.setdefault(
                            node.name, []).append(info)

    @staticmethod
    def _enclosing_class_name(mod: ModuleContext,
                              node: ast.AST) -> str | None:
        parent = mod.parents.get(node)
        return parent.name if isinstance(parent, ast.ClassDef) else None

    # ------------------------------------------------------------- resolve

    def _lookup_in_module(self, mod: ModuleContext,
                          name: str) -> list[FunctionInfo]:
        info = self.top_level.get((mod.relpath, name))
        if info is not None:
            return [info]
        cls = self.classes.get((mod.relpath, name))
        if cls is not None:  # ClassName(...) -> __init__ when defined
            init = cls.get("__init__")
            return [init] if init is not None else []
        return []

    def _resolve_alias(self, mod: ModuleContext,
                       name: str) -> list[FunctionInfo]:
        """`from pkg.mod import f [as g]` / `import pkg.mod as m; m.f`."""
        origin = mod.import_aliases.get(name)
        if not origin or "." not in origin:
            return []
        modname, attr = origin.rsplit(".", 1)
        target = self.by_dotted.get(modname)
        if target is None:
            return []
        return self._lookup_in_module(target, attr)

    def resolve_call(self, mod: ModuleContext,
                     call: ast.Call) -> list[FunctionInfo]:
        """Candidate callees of one call site; [] when unresolvable."""
        func = call.func
        if isinstance(func, ast.Name):
            local = self._lookup_in_module(mod, func.id)
            if local:
                return local
            return self._resolve_alias(mod, func.id)
        if isinstance(func, ast.Attribute):
            # self.m(...) -> the enclosing class's own method
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                for anc in mod.ancestors(call):
                    if isinstance(anc, ast.ClassDef):
                        info = self.classes.get(
                            (mod.relpath, anc.name), {}).get(func.attr)
                        if info is not None:
                            return [info]
                        break
            # m.f(...) through a module alias (import pkg.mod as m)
            dotted = mod.resolve_dotted(func)
            if dotted and "." in dotted:
                modname, attr = dotted.rsplit(".", 1)
                target = self.by_dotted.get(modname)
                if target is not None:
                    return self._lookup_in_module(target, attr)
            # arbitrary receiver: every method of that name in the package
            return list(self.methods_by_name.get(func.attr, []))
        return []

    def resolve_call_strict(self, mod: ModuleContext,
                            call: ast.Call) -> list[FunctionInfo]:
        """resolve_call without the duck-candidate fallback: only
        same-module names, `self.m` on a method the enclosing class itself
        defines, and module-alias dotted calls resolve; an arbitrary
        receiver resolves to nothing. For rules that HAND OFF tracked state
        to the callee (protolint's reply closure): duck candidates would
        claim `queue.append(reply)` hands the reply to SimFile.append."""
        func = call.func
        if isinstance(func, ast.Name):
            local = self._lookup_in_module(mod, func.id)
            return local or self._resolve_alias(mod, func.id)
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                for anc in mod.ancestors(call):
                    if isinstance(anc, ast.ClassDef):
                        info = self.classes.get(
                            (mod.relpath, anc.name), {}).get(func.attr)
                        return [info] if info is not None else []
            dotted = mod.resolve_dotted(func)
            if dotted and "." in dotted:
                modname, attr = dotted.rsplit(".", 1)
                target = self.by_dotted.get(modname)
                if target is not None:
                    return self._lookup_in_module(target, attr)
        return []

    # -------------------------------------------------------------- helpers

    def function_of(self, mod: ModuleContext,
                    node: ast.AST) -> FunctionInfo | None:
        """FunctionInfo owning `node` (nearest enclosing def/async def)."""
        fn = mod.enclosing_function(node)
        if fn is None:
            return None
        return self.functions.get(f"{mod.relpath}::{mod.qualname(fn)}")

    def iter_functions(self):
        return iter(self.functions.values())
