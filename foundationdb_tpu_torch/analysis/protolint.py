"""protolint rules PROTO001..PROTO008: protocol conformance for the RPC layer.

The wire contract lives in three hand-synchronized places: the token table
and request/reply dataclasses (server/interfaces.py), the frame router
(net/transport.py), and the C struct emitters (native/fdb_native.c). flowlint
covers actor discipline and devlint covers device discipline; nothing checked
the protocol itself — a token sent with no registered handler, a handler that
drops its reply promise on one control-flow path (the client then waits out
the full RPC timeout: the resolver-wedge class PR 1 fixed by hand), or a C
emitter whose hard-coded field count silently drifts from the Python
dataclass.

The family shares one package-level analysis (_ProtoAnalysis, cached on the
PackageContext like devlint's): the token census (declarations, register
sites, Endpoint send sites), the dataclass/field index, the statically parsed
wire registry, and an interprocedural reply-settlement interpreter.

Reply settlement (PROTO002) is an abstract interpretation over each
reply-holding function: statements either settle the promise (send/
send_error), hand it off (passed to a resolvable callee — which is then
analyzed itself, so the chain handler -> spawn -> delegate -> helper is
covered), escape it (stored in a container/attribute or passed to an
unresolvable call — conservatively assumed fine), or exit (return/raise).
`await` is the may-raise primitive: in a spawned coroutine an exception or
cancellation landing on an await while the reply is unsettled is NOT
answered by the transport (only sync-handler raises are), so the caller
wedges until RPC timeout. Approximations are one-sided where possible:
unresolvable calls and escapes assume fine (under-approximate), and only
awaits/raises count as may-raise points.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Iterable

from foundationdb_tpu_torch.analysis.callgraph import FunctionInfo, PackageContext
from foundationdb_tpu_torch.analysis.flowlint import (
    Finding, ModuleContext, Rule, register)

_SETTLE_ATTRS = ("send", "send_error")
# builtins that probe a value without retaining it: passing the reply here is
# neither a settle nor an escape
_NOEFFECT_BUILTINS = {"getattr", "hasattr", "isinstance", "len", "bool",
                      "id", "repr", "str", "type", "print"}
# annotation names that encode without a registry entry (utils/wire.py tags)
_WIRE_OK_NAMES = {
    "int", "float", "bool", "str", "bytes", "bytearray", "memoryview",
    "list", "tuple", "dict", "set", "frozenset", "object", "None",
    "Any", "Optional", "Union", "List", "Dict", "Tuple", "Set", "ClassVar",
}

C_RELPATH = "foundationdb_tpu_torch/native/fdb_native.c"


# ---------------------------------------------------------------------------
# C schema parsing (PROTO005) — module-level so tests can feed mutated copies
# ---------------------------------------------------------------------------

@dataclass
class CSchema:
    """One `ClassName { f1: ..., f2 }` schema comment in the C source, plus
    the hard-coded field-count varint of the next 'R' struct emit."""

    name: str
    fields: list[str]
    line: int
    emit_count: int | None  # None when no emitter follows the comment


_C_COMMENT_RE = re.compile(r"/\*.*?\*/", re.S)
_C_SCHEMA_RE = re.compile(r"(\w+)\s*\{([^{}]+)\}")
# the struct emit shape: 'R' tag, type-id varint, then the field-count varint
# as an integer literal (the drift the rule exists to catch)
_C_EMIT_RE = re.compile(
    r"wb_byte\(\s*&\w+\s*,\s*'R'\s*\)[^;]*?"
    r"wb_varint\(\s*&\w+\s*,\s*\w+\s*\)[^;]*?"
    r"wb_varint\(\s*&\w+\s*,\s*(\d+)\s*\)")


def _split_c_fields(body: str) -> list[str] | None:
    """Field names from a schema comment body, splitting on top-level commas
    only (types like `[(0, value|None) | (1, errname)]` contain commas)."""
    parts: list[str] = []
    depth = 0
    cur: list[str] = []
    for ch in body:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    names = []
    for p in parts:
        name = p.split(":", 1)[0].strip()
        if not name.isidentifier():
            return None
        names.append(name)
    return names or None


def parse_c_schemas(source: str) -> list[CSchema]:
    """Every `Name { fields }` schema inside a C comment, with the field
    count of the first struct emit that follows it. Callers filter by
    registered class name — prose braces won't survive that."""
    out: list[CSchema] = []
    for cm in _C_COMMENT_RE.finditer(source):
        text = cm.group(0)
        for sm in _C_SCHEMA_RE.finditer(text):
            fields = _split_c_fields(sm.group(2))
            if fields is None:
                continue
            line = source[:cm.start() + sm.start()].count("\n") + 1
            em = _C_EMIT_RE.search(source, cm.end(), cm.end() + 2500)
            out.append(CSchema(name=sm.group(1), fields=fields, line=line,
                               emit_count=int(em.group(1)) if em else None))
    return out


def c_parity_problems(schemas: list[CSchema],
                      py_fields: dict[str, list[str]],
                      registered: set[str]) -> list[tuple[CSchema, str]]:
    """Cross-check C schemas against the Python dataclass field lists.
    Returns (schema, message) per divergence; tests feed mutated copies of
    either side to prove the gate trips."""
    problems: list[tuple[CSchema, str]] = []
    seen: set[tuple] = set()
    for s in schemas:
        if s.name not in registered:
            continue  # brace-y prose, not a schema
        pf = py_fields.get(s.name)
        if pf is None:
            key = (s.name, "missing")
            if key not in seen:
                seen.add(key)
                problems.append((s, f"C emitter schema for {s.name} has no "
                                    f"matching Python dataclass"))
            continue
        if s.fields != pf:
            key = (s.name, tuple(s.fields))
            if key not in seen:
                seen.add(key)
                problems.append((s, f"C emitter schema for {s.name} lists "
                                    f"fields {s.fields} but the Python "
                                    f"dataclass declares {pf} — the native "
                                    f"fast path would emit frames the Python "
                                    f"decoder mis-fills"))
        if s.emit_count is not None and s.emit_count != len(pf):
            key = (s.name, "count", s.emit_count)
            if key not in seen:
                seen.add(key)
                problems.append((s, f"C emitter for {s.name} hard-codes a "
                                    f"field count of {s.emit_count} but the "
                                    f"Python dataclass has {len(pf)} "
                                    f"field(s) — decode fills the tail from "
                                    f"defaults or truncates"))
    return problems


# ---------------------------------------------------------------------------
# shared package analysis
# ---------------------------------------------------------------------------

@dataclass
class _TokenDecl:
    value: int
    node: ast.AST
    mod: ModuleContext


@dataclass
class _RegSite:
    cls_key: tuple[str, str]  # (relpath, TokenClassName)
    attr: str
    handler: FunctionInfo | None
    node: ast.AST
    mod: ModuleContext


@dataclass
class _SendSite:
    cls_key: tuple[str, str]
    attr: str
    node: ast.AST
    mod: ModuleContext
    kind: str | None = None  # "request" | "one_way" | None (bare Endpoint)
    payload_cls: str | None = None


@dataclass
class _DC:
    name: str
    fields: list[str]
    node: ast.ClassDef
    mod: ModuleContext


class _Out:
    """Abstract-interpretation outcome of a statement list: the possible
    settled-states at fall-through, at returns, and at may-raise points,
    plus the concrete exit nodes observed with an unsettled state."""

    __slots__ = ("fall", "returns", "raises", "bad")

    def __init__(self, fall: Iterable[bool] = ()):
        self.fall: set[bool] = set(fall)
        self.returns: set[bool] = set()
        self.raises: set[bool] = set()
        self.bad: list[tuple[str, ast.AST]] = []  # ("return"|"raise", node)


class _ProtoAnalysis:
    """The census + interpreter every PROTO rule shares."""

    def __init__(self, pkg: PackageContext):
        self.pkg = pkg
        # (relpath, ClassName) -> {ATTR: _TokenDecl}
        self.token_classes: dict[tuple[str, str], dict[str, _TokenDecl]] = {}
        self._token_dotted: dict[str, tuple[str, str]] = {}
        self.registers: list[_RegSite] = []
        self.sends: list[_SendSite] = []
        # token refs that are neither a register arg nor an Endpoint arg:
        # a token passed through a variable (`self._pick_proxy(Token.X)`,
        # `_quorum_call(CoordToken.Y, ...)`) reaches a send site the static
        # Endpoint scan can't see — count it reachable
        self.indirect_refs: set[tuple[tuple[str, str], str]] = set()
        self.dataclasses: dict[str, list[_DC]] = {}
        # wire registry, statically parsed from any module defining
        # _register_all: id -> [names], plus the flat registered-name set
        self.registry_present = False
        self.registry_ids: dict[int, list[tuple[str, ast.AST,
                                                ModuleContext]]] = {}
        self.registered_names: set[str] = set()
        self._outcomes_memo: dict[tuple[str, str], _Out] = {}
        self._collect_tokens()
        self._collect_dataclasses()
        self._collect_registry()
        self._collect_sites()

    # ------------------------------------------------------------- censuses

    def _collect_tokens(self) -> None:
        from foundationdb_tpu_torch.analysis.callgraph import _dotted_module_name
        for mod in self.pkg.modules:
            for node in mod.tree.body:
                if not (isinstance(node, ast.ClassDef)
                        and node.name.endswith("Token")):
                    continue
                decls: dict[str, _TokenDecl] = {}
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign) \
                            and len(stmt.targets) == 1 \
                            and isinstance(stmt.targets[0], ast.Name) \
                            and isinstance(stmt.value, ast.Constant) \
                            and isinstance(stmt.value.value, int):
                        decls[stmt.targets[0].id] = _TokenDecl(
                            stmt.value.value, stmt, mod)
                if not decls:
                    continue
                key = (mod.relpath, node.name)
                self.token_classes[key] = decls
                dn = _dotted_module_name(mod.relpath)
                if dn is not None:
                    self._token_dotted[f"{dn}.{node.name}"] = key

    def resolve_token_ref(self, mod: ModuleContext,
                          expr: ast.AST) -> tuple[tuple[str, str], str] | None:
        """(token class key, ATTR) for `Token.X` / `CoordToken.Y`, through
        import aliases; None when the class isn't in the analyzed set."""
        if not (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)):
            return None
        local = (mod.relpath, expr.value.id)
        if local in self.token_classes:
            return local, expr.attr
        dotted = mod.resolve_dotted(expr.value)
        key = self._token_dotted.get(dotted) if dotted else None
        if key is not None:
            return key, expr.attr
        return None

    def _collect_dataclasses(self) -> None:
        for mod in self.pkg.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                if not any(self._is_dataclass_dec(d)
                           for d in node.decorator_list):
                    continue
                fields = [s.target.id for s in node.body
                          if isinstance(s, ast.AnnAssign)
                          and isinstance(s.target, ast.Name)]
                self.dataclasses.setdefault(node.name, []).append(
                    _DC(node.name, fields, node, mod))

    @staticmethod
    def _is_dataclass_dec(dec: ast.AST) -> bool:
        if isinstance(dec, ast.Call):
            dec = dec.func
        return (isinstance(dec, ast.Name) and dec.id == "dataclass") or \
            (isinstance(dec, ast.Attribute) and dec.attr == "dataclass")

    def dataclass_fields(self, name: str) -> list[str] | None:
        """Field list for `name`, preferring the interfaces module when a
        class name is (unusually) defined twice."""
        entries = self.dataclasses.get(name)
        if not entries:
            return None
        for e in entries:
            if e.mod.relpath.endswith("server/interfaces.py"):
                return e.fields
        return entries[0].fields

    def _collect_registry(self) -> None:
        for mod in self.pkg.modules:
            fn = next((n for n in mod.tree.body
                       if isinstance(n, ast.FunctionDef)
                       and n.name == "_register_all"), None)
            if fn is None:
                continue
            self.registry_present = True
            for n in ast.walk(fn):
                if isinstance(n, ast.Tuple) and len(n.elts) == 2 \
                        and isinstance(n.elts[0], ast.Constant) \
                        and isinstance(n.elts[0].value, int) \
                        and isinstance(n.elts[1], (ast.Name, ast.Attribute)):
                    cls = n.elts[1]
                    name = cls.attr if isinstance(cls, ast.Attribute) \
                        else cls.id
                    self.registry_ids.setdefault(
                        n.elts[0].value, []).append((name, n, mod))
                    self.registered_names.add(name)

    def _collect_sites(self) -> None:
        consumed: set[int] = set()
        for mod in self.pkg.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if isinstance(func, ast.Attribute) \
                        and func.attr == "register" and len(node.args) >= 2:
                    tok = self.resolve_token_ref(mod, node.args[0])
                    if tok is not None:
                        consumed.add(id(node.args[0]))
                        self.registers.append(_RegSite(
                            tok[0], tok[1],
                            self._resolve_handler(mod, node, node.args[1]),
                            node, mod))
                    continue
                if self._is_endpoint_ctor(mod, func) and len(node.args) >= 2:
                    tok = self.resolve_token_ref(mod, node.args[1])
                    if tok is None:
                        continue
                    consumed.add(id(node.args[1]))
                    site = _SendSite(tok[0], tok[1], node, mod)
                    parent = mod.parents.get(node)
                    if isinstance(parent, ast.Call) \
                            and isinstance(parent.func, ast.Attribute) \
                            and parent.func.attr in ("request", "one_way") \
                            and len(parent.args) >= 3:
                        site.kind = parent.func.attr
                        site.payload_cls = self._payload_class(
                            mod, node, parent.args[2])
                    self.sends.append(site)
        for mod in self.pkg.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Attribute) \
                        and id(node) not in consumed:
                    tok = self.resolve_token_ref(mod, node)
                    if tok is not None:
                        self.indirect_refs.add(tok)

    @staticmethod
    def _is_endpoint_ctor(mod: ModuleContext, func: ast.AST) -> bool:
        if isinstance(func, ast.Name) and func.id == "Endpoint":
            return True
        dotted = mod.resolve_dotted(func)
        return bool(dotted) and dotted.endswith(".Endpoint")

    def _resolve_handler(self, mod: ModuleContext, call: ast.Call,
                         expr: ast.AST) -> FunctionInfo | None:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            for anc in mod.ancestors(call):
                if isinstance(anc, ast.ClassDef):
                    return self.pkg.classes.get(
                        (mod.relpath, anc.name), {}).get(expr.attr)
        if isinstance(expr, ast.Name):
            cands = self.pkg.resolve_call(
                mod, ast.Call(func=ast.Name(id=expr.id), args=[],
                              keywords=[]))
            if len(cands) == 1:
                return cands[0]
        return None

    def _payload_class(self, mod: ModuleContext, anchor: ast.AST,
                       expr: ast.AST) -> str | None:
        """Dataclass name a send payload resolves to: a direct constructor,
        or a local `name = Cls(...)` in the enclosing function."""
        if isinstance(expr, ast.Call):
            return self._class_name_of(expr.func)
        if isinstance(expr, ast.Name):
            fn = mod.enclosing_function(anchor)
            if fn is not None:
                for n in ast.walk(fn):
                    if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                            and isinstance(n.targets[0], ast.Name) \
                            and n.targets[0].id == expr.id \
                            and isinstance(n.value, ast.Call):
                        return self._class_name_of(n.value.func)
        return None

    def _class_name_of(self, func: ast.AST) -> str | None:
        name = None
        if isinstance(func, ast.Name):
            name = func.id
        elif isinstance(func, ast.Attribute):
            name = func.attr
        return name if name in self.dataclasses else None

    # -------------------------------------------- reply-settlement machinery

    def handler_params(self, fn: FunctionInfo) -> list[str]:
        a = fn.node.args
        params = [x.arg for x in a.posonlyargs + a.args]
        if fn.class_name is not None and params \
                and params[0] in ("self", "cls"):
            params = params[1:]
        return params

    def reply_param(self, fn: FunctionInfo) -> str | None:
        params = self.handler_params(fn)
        return params[1] if len(params) >= 2 else None

    def _passing_calls(self, param: str, node: ast.AST) -> list[ast.Call]:
        out = []
        for c in ast.walk(node):
            if isinstance(c, ast.Call):
                exprs = list(c.args) + [k.value for k in c.keywords]
                if any(isinstance(x, ast.Name) and x.id == param
                       for e in exprs for x in ast.walk(e)):
                    out.append(c)
        return out

    @staticmethod
    def _innermost(calls: list[ast.Call]) -> list[ast.Call]:
        """Calls whose arg subtree does not contain another passing call —
        spawn(self._commit(req, reply)) credits _commit, not spawn."""
        out = []
        for c in calls:
            arg_nodes = {id(x) for e in (list(c.args)
                                         + [k.value for k in c.keywords])
                         for x in ast.walk(e)}
            if not any(o is not c and id(o) in arg_nodes for o in calls):
                out.append(c)
        return out

    def _map_param(self, cand: FunctionInfo, call: ast.Call,
                   param: str) -> str | None:
        params = self.handler_params(cand)
        for i, argx in enumerate(call.args):
            if isinstance(argx, ast.Name) and argx.id == param:
                return params[i] if i < len(params) else None
        kwonly = [x.arg for x in cand.node.args.kwonlyargs]
        for kw in call.keywords:
            if isinstance(kw.value, ast.Name) and kw.value.id == param \
                    and kw.arg:
                return kw.arg if (kw.arg in params or kw.arg in kwonly) \
                    else None
        return None

    def reply_closure(self, root: FunctionInfo,
                      param: str) -> list[tuple[FunctionInfo, str]]:
        """(function, reply-param-name) pairs reachable from `root` by
        passing the reply through resolvable calls."""
        seen = {(root.fqname, param)}
        order = [(root, param)]
        i = 0
        while i < len(order):
            fn, p = order[i]
            i += 1
            for c in self._passing_calls(p, fn.node):
                for cand in self.pkg.resolve_call_strict(fn.mod, c):
                    mp = self._map_param(cand, c, p)
                    if mp is not None and (cand.fqname, mp) not in seen:
                        seen.add((cand.fqname, mp))
                        order.append((cand, mp))
        return order

    @staticmethod
    def _has_await(node: ast.AST) -> bool:
        return any(isinstance(n, ast.Await) for n in ast.walk(node))

    def _effect(self, fn: FunctionInfo, param: str, node: ast.AST) -> bool:
        """True when executing `node` guarantees the reply is settled or
        handed off/escaped: a direct send/send_error, a pass to a resolvable
        in-package callee (analyzed separately via the closure), or an
        escape (stored, or passed to an unresolvable call)."""
        for n in ast.walk(node):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id == param \
                    and n.func.attr in _SETTLE_ATTRS:
                return True
        passing = self._passing_calls(param, node)
        for c in self._innermost(passing):
            if isinstance(c.func, ast.Name) \
                    and c.func.id in _NOEFFECT_BUILTINS:
                continue
            # any other receiving call counts: a strict-resolvable callee is
            # analyzed itself via reply_closure, an unresolvable one is an
            # escape (assume fine) — either way this frame is off the hook
            return True
        # bare occurrence outside any call argument (x = reply, return reply,
        # tuple literals in assignments): escaped
        covered = {id(x) for c in passing
                   for e in (list(c.args) + [k.value for k in c.keywords])
                   for x in ast.walk(e)}
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id == param \
                    and id(n) not in covered:
                par = fn.mod.parents.get(n)
                if isinstance(par, ast.Attribute):
                    continue  # reply.X probe, not an escape
                return True
        return False

    def _apply(self, fn: FunctionInfo, param: str, node: ast.AST,
               cur: set[bool], out: _Out) -> set[bool]:
        """One simple statement / expression. A raise landing on an await is
        recorded against the PRE-state — unless the awaited expression
        itself consumes the reply (`await self._helper(reply)`): then the
        callee's frame owns the raise path and is analyzed separately."""
        awaits = [n for n in ast.walk(node) if isinstance(n, ast.Await)]
        if awaits:
            consumed = any(self._effect(fn, param, aw.value)
                           for aw in awaits)
            pre = {True} if (consumed and cur) else cur
            out.raises |= pre
            if False in pre:
                out.bad.append(("raise", node))
        if cur and self._effect(fn, param, node):
            return {True}
        return cur

    def _exec(self, fn: FunctionInfo, param: str, stmts: list[ast.stmt],
              in_states: set[bool]) -> _Out:
        out = _Out()
        cur = set(in_states)
        for stmt in stmts:
            if not cur:
                break
            if isinstance(stmt, ast.Return):
                cur = self._apply(fn, param, stmt, cur, out)
                out.returns |= cur
                if False in cur:
                    out.bad.append(("return", stmt))
                cur = set()
            elif isinstance(stmt, ast.Raise):
                out.raises |= cur
                if False in cur:
                    out.bad.append(("raise", stmt))
                cur = set()
            elif isinstance(stmt, ast.If):
                cur = self._apply(fn, param, stmt.test, cur, out)
                o1 = self._exec(fn, param, stmt.body, cur)
                self._merge(out, o1)
                nxt = set(o1.fall)
                if stmt.orelse:
                    o2 = self._exec(fn, param, stmt.orelse, cur)
                    self._merge(out, o2)
                    nxt |= o2.fall
                else:
                    nxt |= cur
                cur = nxt
            elif isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
                head = stmt.test if isinstance(stmt, ast.While) else stmt.iter
                cur = self._apply(fn, param, head, cur, out)
                if isinstance(stmt, ast.AsyncFor):
                    out.raises |= cur
                    if False in cur:
                        out.bad.append(("raise", stmt))
                states = set(cur)
                for _ in range(2):
                    o = self._exec(fn, param, stmt.body, states)
                    self._merge(out, o)
                    states = states | o.fall
                if isinstance(stmt, ast.While) \
                        and isinstance(stmt.test, ast.Constant) \
                        and stmt.test.value is True \
                        and not any(isinstance(n, ast.Break)
                                    for n in ast.walk(stmt)):
                    cur = set()  # while True with no break: no fall-through
                else:
                    cur = states
            elif isinstance(stmt, ast.Try) or \
                    stmt.__class__.__name__ == "TryStar":
                cur = self._exec_try(fn, param, stmt, cur, out)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    cur = self._apply(fn, param, item.context_expr, cur, out)
                if isinstance(stmt, ast.AsyncWith):
                    out.raises |= cur
                    if False in cur:
                        out.bad.append(("raise", stmt))
                o = self._exec(fn, param, stmt.body, cur)
                self._merge(out, o)
                cur = o.fall
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                continue  # nested defs: no effect on this frame's reply
            else:
                cur = self._apply(fn, param, stmt, cur, out)
        out.fall = cur
        return out

    @staticmethod
    def _merge(out: _Out, child: _Out) -> None:
        out.returns |= child.returns
        out.raises |= child.raises
        out.bad.extend(child.bad)

    def _exec_try(self, fn: FunctionInfo, param: str, stmt,
                  cur: set[bool], out: _Out) -> set[bool]:
        o_body = self._exec(fn, param, stmt.body, cur)
        loc = _Out()
        loc.returns |= o_body.returns
        after = set(o_body.fall)
        body_bad = list(o_body.bad)
        if stmt.orelse:
            oe = self._exec(fn, param, stmt.orelse, o_body.fall)
            loc.returns |= oe.returns
            loc.raises |= oe.raises
            loc.bad.extend(oe.bad)
            after = set(oe.fall)
        if stmt.handlers:
            # approximation: every may-raise in the body is caught here (the
            # framework's awaits raise FDBError, and broad handlers dominate
            # this codebase); the handler bodies are analyzed from the
            # settled-states the body could raise in
            loc.bad.extend((k, n) for k, n in body_bad if k != "raise")
            if o_body.raises:
                for h in stmt.handlers:
                    oh = self._exec(fn, param, h.body, set(o_body.raises))
                    loc.returns |= oh.returns
                    loc.raises |= oh.raises
                    loc.bad.extend(oh.bad)
                    after |= oh.fall
        else:
            loc.raises |= o_body.raises
            loc.bad.extend(body_bad)
        if stmt.finalbody:
            probe = self._exec(fn, param, stmt.finalbody, {False})
            if probe.fall == {True}:
                # finally settles unconditionally: every exit through it is
                # settled, so local unsettled exits are rescued
                after = {True} if after else after
                loc.returns = {True} if loc.returns else loc.returns
                loc.raises = {True} if loc.raises else loc.raises
                loc.bad = []
            else:
                o_fin = self._exec(fn, param, stmt.finalbody, after)
                self._merge(loc, o_fin)
                after = o_fin.fall
        self._merge(out, loc)
        return after

    def outcomes(self, fn: FunctionInfo, param: str) -> _Out:
        key = (fn.fqname, param)
        got = self._outcomes_memo.get(key)
        if got is None:
            got = self._exec(fn, param, fn.node.body, {False})
            self._outcomes_memo[key] = got
        return got

    # ----------------------------------------------------- derived indexes

    def registered_tokens(self) -> set[tuple[tuple[str, str], str]]:
        return {(r.cls_key, r.attr) for r in self.registers}

    def sent_tokens(self) -> set[tuple[tuple[str, str], str]]:
        return {(s.cls_key, s.attr) for s in self.sends}

    def handlers_of(self, cls_key: tuple[str, str],
                    attr: str) -> list[FunctionInfo]:
        out, seen = [], set()
        for r in self.registers:
            if (r.cls_key, r.attr) == (cls_key, attr) \
                    and r.handler is not None \
                    and r.handler.fqname not in seen:
                seen.add(r.handler.fqname)
                out.append(r.handler)
        return out


def _analysis(pkg: PackageContext) -> _ProtoAnalysis:
    a = pkg.caches.get("protolint")
    if a is None:
        a = _ProtoAnalysis(pkg)
        pkg.caches["protolint"] = a
    return a


# -------------------------------------------------------------- PROTO001

@register
class TokenRouting(Rule):
    code = "PROTO001"
    summary = ("token <-> handler coverage: duplicate token ints (frames "
               "route to the wrong handler silently), tokens sent but never "
               "register()ed (callers get broken_promise), registered but "
               "unreachable from any send site, or declared dead")

    def check_package(self, pkg: PackageContext) -> Iterable[Finding]:
        ana = _analysis(pkg)
        by_value: dict[int, list[tuple[tuple[str, str], str]]] = {}
        for key, decls in sorted(ana.token_classes.items()):
            for attr, d in sorted(decls.items()):
                by_value.setdefault(d.value, []).append((key, attr))
        for value, owners in sorted(by_value.items()):
            if len(owners) > 1:
                names = ", ".join(f"{k[1]}.{a}" for k, a in owners)
                for key, attr in owners[1:]:
                    d = ana.token_classes[key][attr]
                    yield self.finding(
                        d.mod, d.node, f"{key[1]}.{attr}",
                        f"token value {value} is bound to {names} — token "
                        f"ints share one routing namespace per process; a "
                        f"duplicate silently routes frames to whichever "
                        f"handler registered last")
        registered = ana.registered_tokens()
        sent = ana.sent_tokens()
        for s in ana.sends:
            if (s.cls_key, s.attr) not in registered:
                yield self.finding(
                    s.mod, s.node, f"{s.cls_key[1]}.{s.attr}",
                    f"{s.cls_key[1]}.{s.attr} is sent to but no role "
                    f"register()s it — every request gets broken_promise")
        reachable = sent | ana.indirect_refs
        reported: set[tuple] = set()
        for r in ana.registers:
            tok = (r.cls_key, r.attr)
            if tok not in reachable and tok not in reported:
                reported.add(tok)
                yield self.finding(
                    r.mod, r.node, f"{r.cls_key[1]}.{r.attr}",
                    f"{r.cls_key[1]}.{r.attr} is registered but unreachable "
                    f"from any Endpoint send site — dead handler")
        for key, decls in sorted(ana.token_classes.items()):
            for attr, d in sorted(decls.items()):
                tok = (key, attr)
                if tok not in registered and tok not in reachable:
                    yield self.finding(
                        d.mod, d.node, f"{key[1]}.{attr}",
                        f"{key[1]}.{attr} is declared but neither "
                        f"registered nor sent — dead protocol surface")


# -------------------------------------------------------------- PROTO002

@register
class ReplyOnAllPaths(Rule):
    code = "PROTO002"
    summary = ("a handler (or the coroutine it spawns) can exit with its "
               "reply promise unsettled — early return, or an await that "
               "raises/cancels outside a settling try — wedging the caller "
               "until the full RPC timeout. Interprocedural through every "
               "call the reply is passed to.")

    def check_package(self, pkg: PackageContext) -> Iterable[Finding]:
        ana = _analysis(pkg)
        emitted: set[tuple] = set()
        roots: list[tuple[FunctionInfo, str]] = []
        seen_roots: set[str] = set()
        for r in ana.registers:
            if r.handler is None or r.handler.fqname in seen_roots:
                continue
            seen_roots.add(r.handler.fqname)
            param = ana.reply_param(r.handler)
            if param is not None:
                roots.append((r.handler, param))
        for root, root_param in roots:
            for fn, param in ana.reply_closure(root, root_param):
                out = ana.outcomes(fn, param)
                if False in out.fall:
                    key = (fn.fqname, "fall")
                    if key not in emitted:
                        emitted.add(key)
                        yield self.finding(
                            fn.mod, fn.node, "fall-unsettled",
                            f"{fn.qualname} can fall off the end without "
                            f"settling the reply promise — the caller waits "
                            f"out the full RPC timeout")
                for kind, node in out.bad:
                    if kind == "raise" and not fn.is_async:
                        continue  # sync-handler raises are answered by the
                        # transport (unknown_error); spawned-coroutine
                        # raises are not
                    key = (fn.fqname, kind, id(node))
                    if key not in emitted:
                        emitted.add(key)
                        if kind == "return":
                            msg = (f"{fn.qualname} returns with the reply "
                                   f"promise possibly unsettled — the "
                                   f"caller waits out the full RPC timeout")
                        else:
                            msg = (f"an await in {fn.qualname} can raise or "
                                   f"be cancelled while the reply is "
                                   f"unsettled; errors in a spawned "
                                   f"coroutine are not answered by the "
                                   f"transport — settle (or send_error) in "
                                   f"an enclosing try")
                        yield self.finding(fn.mod, node,
                                           f"{kind}-unsettled", msg)


# -------------------------------------------------------------- PROTO003

@register
class RequestReplyPairing(Rule):
    code = "PROTO003"
    summary = ("request/reply type pairing: one token sent with different "
               "request dataclasses, a handler annotated for a different "
               "request type than its senders construct, or one token's "
               "handlers constructing different reply dataclasses")

    def check_package(self, pkg: PackageContext) -> Iterable[Finding]:
        ana = _analysis(pkg)
        by_tok: dict[tuple, list[_SendSite]] = {}
        for s in ana.sends:
            if s.payload_cls is not None:
                by_tok.setdefault((s.cls_key, s.attr), []).append(s)
        for tok, sites in sorted(by_tok.items()):
            classes = sorted({s.payload_cls for s in sites})
            label = f"{tok[0][1]}.{tok[1]}"
            if len(classes) > 1:
                yield self.finding(
                    sites[0].mod, sites[0].node, label,
                    f"{label} is sent with inconsistent request types: "
                    f"{', '.join(classes)} — one token must resolve to one "
                    f"request dataclass")
                continue
            req_cls = classes[0]
            for h in ana.handlers_of(*tok):
                ann = self._req_annotation(ana, h)
                if ann is not None and ann != req_cls:
                    yield self.finding(
                        h.mod, h.node, label,
                        f"handler {h.qualname} annotates its request as "
                        f"{ann} but senders of {label} construct {req_cls}")
        for tok in sorted(set(by_tok) | {(r.cls_key, r.attr)
                                         for r in ana.registers}):
            replies: set[str] = set()
            anchor: FunctionInfo | None = None
            for h in ana.handlers_of(*tok):
                param = ana.reply_param(h)
                if param is None:
                    continue
                anchor = anchor or h
                for fn, p in ana.reply_closure(h, param):
                    replies |= self._reply_ctors(ana, fn, p)
            if len(replies) > 1 and anchor is not None:
                label = f"{tok[0][1]}.{tok[1]}"
                yield self.finding(
                    anchor.mod, anchor.node, label,
                    f"handlers of {label} construct inconsistent reply "
                    f"types: {', '.join(sorted(replies))}")

    @staticmethod
    def _req_annotation(ana: _ProtoAnalysis,
                        fn: FunctionInfo) -> str | None:
        a = fn.node.args
        args = a.posonlyargs + a.args
        if fn.class_name is not None and args \
                and args[0].arg in ("self", "cls"):
            args = args[1:]
        if not args:
            return None
        ann = args[0].annotation
        name = None
        if isinstance(ann, ast.Name):
            name = ann.id
        elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.split(".")[-1]
        elif isinstance(ann, ast.Attribute):
            name = ann.attr
        return name if name in ana.dataclasses else None

    @staticmethod
    def _reply_ctors(ana: _ProtoAnalysis, fn: FunctionInfo,
                     param: str) -> set[str]:
        out: set[str] = set()
        for n in ast.walk(fn.node):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id == param and n.func.attr == "send" \
                    and n.args and isinstance(n.args[0], ast.Call):
                name = ana._class_name_of(n.args[0].func)
                if name is not None:
                    out.add(name)
        return out


# -------------------------------------------------------------- PROTO004

@register
class SerializerConformance(Rule):
    code = "PROTO004"
    summary = ("wire-serializer conformance: a dataclass crossing "
               "NetTransport with no registry entry (WireError at the first "
               "real-transport send — invisible under the sim, which "
               "delivers by reference), a duplicate wire id, or a "
               "registered dataclass whose field type is an unregistered "
               "dataclass")

    def check_package(self, pkg: PackageContext) -> Iterable[Finding]:
        ana = _analysis(pkg)
        if not ana.registry_present:
            return
        for tid, entries in sorted(ana.registry_ids.items()):
            if len(entries) > 1:
                names = ", ".join(e[0] for e in entries)
                name, node, mod = entries[1]
                yield self.finding(
                    mod, node, f"id:{tid}",
                    f"wire type id {tid} is pinned to more than one class "
                    f"({names}) — ids are wire format and must be unique")
        for s in ana.sends:
            if s.payload_cls is not None \
                    and s.payload_cls not in ana.registered_names:
                yield self.finding(
                    s.mod, s.node, s.payload_cls,
                    f"{s.payload_cls} crosses the transport at this send "
                    f"site but has no wire-registry entry — the first "
                    f"real-network send raises WireError (the sim delivers "
                    f"by reference and never catches this)")
        for name in sorted(ana.registered_names):
            for dc in ana.dataclasses.get(name, ()):
                yield from self._check_fields(ana, dc)

    def _check_fields(self, ana: _ProtoAnalysis,
                      dc: _DC) -> Iterable[Finding]:
        for stmt in dc.node.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            ann = stmt.annotation
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                try:
                    ann = ast.parse(ann.value, mode="eval").body
                except SyntaxError:
                    continue
            for n in ast.walk(ann):
                if isinstance(n, ast.Name) \
                        and n.id not in _WIRE_OK_NAMES \
                        and n.id in ana.dataclasses \
                        and n.id not in ana.registered_names:
                    yield self.finding(
                        dc.mod, stmt, f"{dc.name}.{stmt.target.id}",
                        f"registered dataclass {dc.name} field "
                        f"'{stmt.target.id}' is typed {n.id}, a dataclass "
                        f"with no wire-registry entry — encoding raises "
                        f"WireError on the first populated instance")


# -------------------------------------------------------------- PROTO005

@register
class CSchemaParity(Rule):
    code = "PROTO005"
    summary = ("Python<->C schema parity: the struct schemas and hard-coded "
               "field counts in native/fdb_native.c's wire-frame emitters "
               "must match the Python dataclass field lists — a field added "
               "on one side silently mis-fills decoded replies")

    def check_package(self, pkg: PackageContext) -> Iterable[Finding]:
        ana = _analysis(pkg)
        if not ana.registry_present:
            return  # snippet run: no wire registry, nothing to cross-check
        c_path = self._c_source_path(pkg)
        if c_path is None:
            return
        with open(c_path, encoding="utf-8") as f:
            source = f.read()
        py_fields = {name: ana.dataclass_fields(name)
                     for name in ana.registered_names}
        py_fields = {k: v for k, v in py_fields.items() if v is not None}
        for schema, message in c_parity_problems(
                parse_c_schemas(source), py_fields, ana.registered_names):
            yield Finding(rule=self.code, path=C_RELPATH, line=schema.line,
                          symbol=schema.name,
                          detail=f"{schema.name}:schema", message=message)

    @staticmethod
    def _c_source_path(pkg: PackageContext) -> str | None:
        """The C source next to the analyzed package, found from the wire
        module's location on disk (works no matter the analysis cwd)."""
        from foundationdb_tpu_torch.analysis import flowlint
        path = os.path.join(flowlint.default_target(),
                            "native", "fdb_native.c")
        return path if os.path.exists(path) else None


# -------------------------------------------------------------- PROTO006

@register
class TimeoutDiscipline(Rule):
    code = "PROTO006"
    summary = ("request(..., timeout=None) not wrapped in loop.timeout(...) "
               "— an unbounded remote wait survives peer death only via "
               "broken_promise; anything else wedges the caller forever")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "request"):
                continue
            if not any(kw.arg == "timeout"
                       and isinstance(kw.value, ast.Constant)
                       and kw.value.value is None
                       for kw in node.keywords):
                continue
            wrapped = any(isinstance(anc, ast.Call)
                          and isinstance(anc.func, ast.Attribute)
                          and anc.func.attr == "timeout"
                          for anc in mod.ancestors(node))
            if not wrapped:
                yield self.finding(
                    mod, node, "timeout=None",
                    "request(..., timeout=None) with no enclosing "
                    "loop.timeout(...): the wait is unbounded — bound the "
                    "delivery or document why the wait may be infinite")


# -------------------------------------------------------------- PROTO007

@register
class RetransmitDedup(Rule):
    code = "PROTO007"
    summary = ("retransmit-dedup discipline: a request type carrying "
               "request_num must also carry the epoch fence, and its "
               "handlers must actually read request_num (a retried request "
               "that is not deduped double-allocates/double-applies)")

    def check_package(self, pkg: PackageContext) -> Iterable[Finding]:
        ana = _analysis(pkg)
        for name, entries in sorted(ana.dataclasses.items()):
            for dc in entries:
                if "request_num" in dc.fields and "epoch" not in dc.fields:
                    yield self.finding(
                        dc.mod, dc.node, name,
                        f"{name} carries request_num (a retried request) "
                        f"but no epoch fence — a retransmit answered by a "
                        f"deposed generation's handler dedup cache crosses "
                        f"recovery boundaries")
        by_tok: dict[tuple, str] = {}
        for s in ana.sends:
            if s.payload_cls is not None:
                fields = ana.dataclass_fields(s.payload_cls) or []
                if "request_num" in fields:
                    by_tok[(s.cls_key, s.attr)] = s.payload_cls
        for tok, cls in sorted(by_tok.items()):
            for h in ana.handlers_of(*tok):
                param = ana.reply_param(h)
                closure = (ana.reply_closure(h, param)
                           if param is not None else [(h, "")])
                if not any(self._reads_request_num(fn)
                           for fn, _p in closure):
                    yield self.finding(
                        h.mod, h.node, f"{cls}->{h.name}",
                        f"handler {h.qualname} receives {cls} (which "
                        f"carries request_num) but never reads it — "
                        f"retransmitted requests are re-executed instead "
                        f"of answered from the dedup cache")

    @staticmethod
    def _reads_request_num(fn: FunctionInfo) -> bool:
        return any(isinstance(n, ast.Attribute) and n.attr == "request_num"
                   for n in ast.walk(fn.node))


# -------------------------------------------------------------- PROTO008

@register
class ReplyErrorHandling(Rule):
    code = "PROTO008"
    summary = ("an awaited request inside a long-running (while) loop with "
               "no try between the await and the loop — one reply-error "
               "frame (kind=2: dead peer, deposed role, handler raise) "
               "kills the actor permanently instead of one iteration")

    def check(self, mod: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Await):
                continue
            if not any(isinstance(c, ast.Call)
                       and isinstance(c.func, ast.Attribute)
                       and c.func.attr == "request"
                       for c in ast.walk(node.value)):
                continue
            guarded = False
            loop = None
            for anc in mod.ancestors(node):
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    break
                if isinstance(anc, ast.Try) and anc.handlers:
                    # a try anywhere in the function counts — outside the
                    # loop it converts "actor dies" into a handled exit
                    guarded = True
                if isinstance(anc, ast.While) and loop is None:
                    loop = anc
            if loop is not None and not guarded:
                yield self.finding(
                    mod, node, "unguarded-await",
                    "awaited request inside a long-running loop with no "
                    "try/except between the await and the loop — a single "
                    "reply-error (dead peer, deposed role) permanently "
                    "kills this actor; catch FDBError per iteration")
