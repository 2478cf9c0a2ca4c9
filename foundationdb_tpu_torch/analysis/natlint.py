"""natlint rules NAT001..NAT007: native C-extension discipline.

flowlint guards actor code, devlint the device hot path, protolint the wire
contract — but native/fdb_native.c (the zero-Python data plane: CRC, block
codec, wire codec, conflict-range encoder, OMap/VStore skiplists) was only
covered indirectly, by parity fuzzes that notice divergence, not memory
errors. This family reads the C itself through the csource front-end and
checks each function's *shape*:

  NAT001  allocation results (malloc / PyMem_* / PyBytes_FromStringAndSize)
          used before any NULL test.
  NAT002  refcount balance on error paths: every `goto err*` ladder or
          early `return NULL`/-1 must release exactly the owned refs
          acquired so far (new-ref acquisitions tracked through loop
          conditions; stolen-ref stores, returns and alias stores end
          ownership; Py_XDECREF in the resolved goto ladder counts).
  NAT003  error returns of fallible CPython calls ignored — including the
          PyLong_As* family whose -1 is ambiguous without PyErr_Occurred().
  NAT004  raw buffer access with no dominating bounds check: memcpy /
          pointer arithmetic on Py_buffer-derived pointers outside a
          dominating `.len` comparison (the decode-side `goto corrupt`
          pattern is the compliant shape), and PySequence_Fast_GET_ITEM on
          objects never validated by PySequence_Fast / GET_SIZE.
  NAT005  wire-struct emits inconsistent with the PROTO005 schema comments:
          a hard-coded field-count varint that disagrees with the comment's
          field list, or an 'R' struct emit with no schema comment at all
          (shares protolint.parse_c_schemas — one C schema model).
  NAT006  GIL held across an unbounded pure-C bulk loop (a static helper
          looping over a caller-supplied byte length with zero CPython
          calls) from an entry point with no Py_BEGIN_ALLOW_THREADS window.
  NAT007  decoded counts trusted before validation: an integer read out of
          the input buffer (memcpy-into or varint) used as an allocation
          size with no dominating value check.

Like the static dominance model in csource, every approximation here is
chosen one-sided: borrowed-ref calls are not acquisitions, unresolvable
stores count as escapes, and a conditional release only cancels ownership
where it dominates. tests/test_natlint.py pins each rule on fixtures both
ways (violating and compliant), pins the pre-fix live-violation shapes this
family found in fdb_native.c, and mutation-proves NAT002 by deleting a
Py_DECREF from a real error ladder.

Inline suppression in C uses a comment `/* natlint: ignore[NAT00X] */` on
the flagged line or the line above (see csource.suppressions).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Iterable

from foundationdb_tpu_torch.analysis import csource
from foundationdb_tpu_torch.analysis.flowlint import Finding, Rule, register
from foundationdb_tpu_torch.analysis.protolint import (
    C_RELPATH, _C_COMMENT_RE, _C_EMIT_RE, _C_SCHEMA_RE, parse_c_schemas)

# CPython constructors and other calls whose result is a NEW reference the
# caller owns. Borrowed-ref calls (PyDict_GetItem, *_GET_ITEM) are
# deliberately absent — listing one would fabricate leaks.
NEWREF_FNS = frozenset((
    "PyLong_FromLong", "PyLong_FromLongLong", "PyLong_FromUnsignedLong",
    "PyLong_FromUnsignedLongLong", "PyLong_FromSsize_t", "PyLong_FromSize_t",
    "PyFloat_FromDouble", "PyBool_FromLong", "PyBytes_FromStringAndSize",
    "PyBytes_FromString", "PyUnicode_FromString", "PyUnicode_DecodeUTF8",
    "PyUnicode_FromStringAndSize", "PyList_New", "PyTuple_New",
    "PyDict_New", "PySet_New", "PyTuple_Pack", "PySequence_Fast",
    "PyObject_GetIter", "PyIter_Next", "PyObject_GetAttrString",
    "PyObject_CallObject", "PyObject_CallOneArg", "PyObject_CallNoArgs",
    "PyObject_Call", "PyObject_CallFunctionObjArgs", "PyObject_Str",
    "Py_BuildValue", "Py_NewRef", "PyErr_NewException", "PyModule_Create",
    "PySequence_List", "PySequence_Tuple", "PyDict_Copy",
))

# calls that STEAL a reference to one of their arguments
STEALER_FNS = frozenset((
    "PyList_SET_ITEM", "PyTuple_SET_ITEM", "PyList_SetItem",
    "PyTuple_SetItem", "PyModule_AddObject",
))

# raw allocators whose NULL return must be tested (NAT001)
ALLOC_FNS = frozenset((
    "malloc", "calloc", "realloc", "PyMem_Malloc", "PyMem_Calloc",
    "PyMem_Realloc", "PyMem_RawMalloc", "PyMem_RawRealloc", "PyMem_New",
    "PyObject_Malloc", "PyBytes_FromStringAndSize",
))

# fallible CPython calls and how their error return is signalled (NAT003):
#   neg    -> returns a negative int on error; any dominating condition
#             mentioning the result (or calling inside a condition) counts
#   zero   -> returns 0/NULL-ish falsy on error; same acceptance
#   errocc -> -1 is a VALID value too: the check must involve
#             PyErr_Occurred() or an explicit -1 comparison
FALLIBLE_FNS = {
    "PyObject_IsTrue": "neg", "PyObject_Not": "neg",
    "PyObject_SetAttrString": "neg", "PyList_Append": "neg",
    "PyDict_SetItem": "neg", "PyDict_SetItemString": "neg",
    "PyObject_GetBuffer": "neg", "PyBytes_AsStringAndSize": "neg",
    "PyObject_SetItem": "neg", "PyList_Sort": "neg", "PyType_Ready": "neg",
    "PyModule_AddObject": "neg", "PyModule_AddIntConstant": "neg",
    "PyArg_ParseTuple": "zero", "PyArg_ParseTupleAndKeywords": "zero",
    "PyLong_AsLong": "errocc", "PyLong_AsLongLong": "errocc",
    "PyLong_AsUnsignedLongLong": "errocc", "PyLong_AsSsize_t": "errocc",
    "PyLong_AsSize_t": "errocc", "PyFloat_AsDouble": "errocc",
}

# allocation calls whose size argument a decoded count must not reach
# unvalidated (NAT007)
SIZE_SINK_FNS = ("PyList_New", "PyTuple_New", "PyBytes_FromStringAndSize",
                 "malloc", "calloc", "realloc", "PyMem_Malloc",
                 "PyMem_New", "PyMem_Realloc")

_COND_KINDS = ("if", "for", "while", "do", "switch")

# the size a pure-C bulk loop must be gated on before NAT006 considers the
# entry compliant without a window is a policy question for the fix, not
# the rule: the rule only demands SOME Py_BEGIN_ALLOW_THREADS in the caller
GIL_WINDOW = "Py_BEGIN_ALLOW_THREADS"

_CAST_CALL_RE = re.compile(
    r"^(?:\(\s*[\w\s\*]+?\s*\)\s*)*([A-Za-z_]\w*)\s*\(")


def _normalize(text: str) -> str:
    return text.replace(" ", "")


def _mentions_plain(text: str, var: str) -> bool:
    """var appears as a plain value: not `&var` (address-of for an out
    param) and not `x.var` / `x->var` (a member that shares the name)."""
    for m in re.finditer(rf"\b{re.escape(var)}\b", text):
        j = m.start() - 1
        while j >= 0 and text[j] == " ":
            j -= 1
        if j >= 0 and text[j] == "&" and text[j - 1:j] != "&":
            continue  # `&var` address-of; `&& var` is a plain mention
        if j >= 0 and (text[j] == "." or text[j - 1:j + 1] == "->"):
            continue
        return True
    return False


def _split_assign(text: str) -> tuple[str, str, str] | None:
    """(lhs_var, lhs_text, rhs) of a token-text assignment, or None. Token
    join guarantees a lone `=` appears as ` = ` while `==`/`+=`/... stay
    single tokens, so the match is unambiguous."""
    padded = f" {text} "
    idx = padded.find(" = ")
    if idx < 0:
        return None
    lhs = padded[:idx].strip()
    rhs = padded[idx + 3:].strip()
    m = re.search(r"([A-Za-z_]\w*)\s*$", lhs)
    if m is None:
        return None
    return m.group(1), lhs, rhs


def _leading_call(rhs: str) -> str | None:
    m = _CAST_CALL_RE.match(rhs)
    return m.group(1) if m else None


def _call_args(text: str, open_paren: int) -> list[str]:
    """Top-level comma-split arguments of the call whose '(' sits at
    `open_paren` in `text`."""
    depth, cur, out = 0, [], []
    for ch in text[open_paren:]:
        if ch in "([":
            depth += 1
            if depth == 1:
                continue
        elif ch in ")]":
            depth -= 1
            if depth == 0:
                break
        if depth == 1 and ch == ",":
            out.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return out


@dataclass
class _Acq:
    var: str
    stmt: csource.Stmt
    fn_name: str      # the acquiring call, for messages
    in_loop_cond: bool


class _FnModel:
    """Shared per-function facts the NAT rules query."""

    def __init__(self, fn: csource.CFunction):
        self.fn = fn
        self.texts: list[tuple[csource.Stmt, str, bool]] = []
        for s in fn.flat:
            if s.kind in ("simple", "return", "goto"):
                self.texts.append((s, s.text, False))
            elif s.kind in _COND_KINDS:
                self.texts.append((s, s.text, True))
        self.assigns: list[tuple[csource.Stmt, str, str, bool]] = []
        for s, text, is_cond in self.texts:
            if s.kind == "return":
                continue
            sp = _split_assign(text)
            if sp is not None:
                self.assigns.append((s, sp[0], sp[2], is_cond))
        self.acquisitions: list[_Acq] = []
        for s, var, rhs, is_cond in self.assigns:
            call = _leading_call(rhs)
            if call in NEWREF_FNS:
                self.acquisitions.append(_Acq(
                    var=var, stmt=s, fn_name=call,
                    in_loop_cond=is_cond and s.is_loop))
        for s, text, _ in self.texts:
            for m in re.finditer(r"Py_X?INCREF\s*\(\s*([A-Za-z_]\w*)\s*\)",
                                 text):
                self.acquisitions.append(_Acq(
                    var=m.group(1), stmt=s, fn_name="Py_INCREF",
                    in_loop_cond=False))

    # -- ownership events -------------------------------------------------

    def releases_in(self, stmt: csource.Stmt, var: str) -> bool:
        for text in (stmt.text,):
            for m in re.finditer(
                    r"Py_(?:XDECREF|DECREF|CLEAR)\s*\(\s*([A-Za-z_]\w*)"
                    r"\s*\)|Py_SETREF\s*\(\s*([A-Za-z_]\w*)\s*,", text):
                if var in m.groups():
                    return True
        return False

    def ends_ownership(self, stmt: csource.Stmt, var: str) -> bool:
        """Release, escape, or reassignment of `var` at this statement."""
        text = stmt.text
        if self.releases_in(stmt, var):
            return True
        if stmt.kind == "return" and _mentions_plain(text, var):
            return True
        if any(fn in text for fn in STEALER_FNS) \
                and _mentions_plain(text, var):
            return True
        sp = _split_assign(text) if stmt.kind == "simple" else None
        if sp is not None:
            lhs_var, _, rhs = sp
            if lhs_var == var:
                return True  # rebound: the old ref's story ends here
            if _mentions_plain(rhs, var):
                return True  # aliased into a structure the callee owns
        return False

    def null_guarded(self, exit_stmt: csource.Stmt, var: str) -> bool:
        """The exit sits in the failure branch of var's own NULL test —
        var is provably NULL there, nothing to release."""
        for anc in self.fn.ancestors(exit_stmt):
            if anc.kind != "if":
                continue
            depth = len(anc.block)
            if len(exit_stmt.block) <= depth \
                    or exit_stmt.block[depth] != anc.order:
                continue  # in the else branch (or unrelated)
            cond = anc.text
            if re.search(rf"!\s*{re.escape(var)}\b", cond) \
                    or re.search(rf"\b{re.escape(var)}\s*==\s*NULL", cond) \
                    or re.search(rf"NULL\s*==\s*{re.escape(var)}", cond) \
                    or ("!" in cond and " = " in f" {cond} "
                        and _mentions_plain(cond, var)):
                return True
        return False

    def dominating(self, target: csource.Stmt):
        for s in self.fn.flat:
            if self.fn.dominates(s, target):
                yield s

    def first_mention_after(self, stmt: csource.Stmt, var: str
                            ) -> csource.Stmt | None:
        for s in self.fn.flat[stmt.order + 1:]:
            if s.text and re.search(rf"\b{re.escape(var)}\b", s.text):
                return s
        return None


# ---------------------------------------------------------------------------
# per-function checks (NAT001/2/3/4/6/7) and the schema check (NAT005)
# ---------------------------------------------------------------------------

def _f(code: str, relpath: str, line: int, symbol: str, detail: str,
       message: str) -> Finding:
    return Finding(rule=code, path=relpath, line=line, symbol=symbol,
                   detail=detail, message=message)


def _check_alloc(model: _FnModel, relpath: str) -> Iterable[Finding]:
    fn = model.fn
    for s, var, rhs, is_cond in model.assigns:
        call = _leading_call(rhs)
        if call not in ALLOC_FNS or is_cond:
            continue
        use = model.first_mention_after(s, var)
        if use is None:
            continue  # result parked; a later pass may see the real use
        if use.kind in _COND_KINDS or use.kind == "return":
            continue  # tested (or propagated for the caller to test)
        if re.search(rf"\b{re.escape(var)}\s*\?", use.text):
            continue  # ternary NULL test: `x = var ? f(var) : NULL`
        yield _f("NAT001", relpath, use.line, fn.name,
                 f"unchecked-alloc:{var}",
                 f"{call}() result '{var}' (line {s.line}) is used before "
                 f"any NULL test — allocation failure dereferences NULL")
    # allocation calls whose result never lands in a variable at all
    for s, text, is_cond in model.texts:
        if is_cond or s.kind == "return":
            continue
        sp = _split_assign(text)
        for call in ALLOC_FNS:
            m = re.search(rf"\b{call}\s*\(", text)
            if m is None:
                continue
            if sp is not None and _leading_call(sp[2]) == call:
                continue  # the assigned case above
            yield _f("NAT001", relpath, s.line, fn.name,
                     f"discarded-alloc:{call}",
                     f"{call}() called with its result consumed inline — "
                     f"a NULL on allocation failure flows straight into "
                     f"the surrounding expression")


def _check_refcounts(model: _FnModel, relpath: str) -> Iterable[Finding]:
    fn = model.fn
    if fn.name.startswith("PyInit_"):
        return  # module init: PyModule_AddObject steal-on-success noise
    for exit_stmt, path, term in fn.exits():
        if term is None:
            continue
        ret = _normalize(term.text)
        if ret not in ("NULL", "-1"):
            continue
        for acq in model.acquisitions:
            v, s = acq.var, acq.stmt
            if acq.in_loop_cond:
                pfx = s.block + (s.order,)
                if exit_stmt.block[:len(pfx)] != pfx:
                    continue  # loop-cond ref is NULL once the loop exits
                if exit_stmt.order <= s.order:
                    continue
            elif not fn.dominates(s, exit_stmt):
                continue
            if exit_stmt is s:
                continue
            if any(r.order > s.order and model.ends_ownership(r, v)
                   for r in model.dominating(exit_stmt)):
                continue
            if any(model.releases_in(p, v) for p in path):
                continue
            if model.null_guarded(exit_stmt, v):
                continue
            where = f"goto {exit_stmt.label}" if exit_stmt.kind == "goto" \
                else f"return {term.text}"
            yield _f("NAT002", relpath, exit_stmt.line, fn.name,
                     f"leak:{v}@{exit_stmt.label or 'return'}",
                     f"error path `{where}` (line {exit_stmt.line}) exits "
                     f"without releasing '{v}', acquired from "
                     f"{acq.fn_name}() at line {s.line} — the ref leaks "
                     f"on every failure through this path")


def _check_fallible(model: _FnModel, relpath: str) -> Iterable[Finding]:
    fn = model.fn
    for s, text, is_cond in model.texts:
        if is_cond or s.kind == "return":
            continue  # tested in a condition / propagated to the caller
        if text.startswith("( void )"):
            continue
        sp = _split_assign(text)
        for call, mode in FALLIBLE_FNS.items():
            if re.search(rf"\b{call}\s*\(", text) is None:
                continue
            if sp is not None and _leading_call(sp[2]) == call:
                var = sp[0]
                use = model.first_mention_after(s, var)
                if use is not None and use.kind in _COND_KINDS + ("return",):
                    if mode != "errocc":
                        continue
                    cond = use.text
                    if "PyErr_Occurred" in cond \
                            or "-1" in _normalize(cond):
                        continue
                    yield _f("NAT003", relpath, use.line, fn.name,
                             f"ambiguous-errcheck:{call}:{var}",
                             f"'{var}' from {call}() is tested without "
                             f"PyErr_Occurred()/-1 — a legitimate -1 "
                             f"value and an error are indistinguishable")
                    continue
                where = use.line if use is not None else s.line
                yield _f("NAT003", relpath, where, fn.name,
                         f"unchecked-call:{call}:{var}",
                         f"'{var}' from fallible {call}() (line {s.line}) "
                         f"is used before any error test — a pending "
                         f"exception propagates into garbage data")
            else:
                yield _f("NAT003", relpath, s.line, fn.name,
                         f"ignored-call:{call}",
                         f"error return of {call}() is ignored — on "
                         f"failure an exception is left pending for some "
                         f"unrelated later call to trip over")


def _check_buffers(model: _FnModel, relpath: str) -> Iterable[Finding]:
    fn = model.fn
    # -- PySequence_Fast discipline --------------------------------------
    fastvars = {var for _, var, rhs, _ in model.assigns
                if _leading_call(rhs) == "PySequence_Fast"}
    # a PyObject* parameter was validated by the caller (static helpers
    # like enc_container_items receive an already-Fast sequence)
    param_objs = {p.name for p in fn.params if "PyObject" in p.type}
    sizevars: dict[str, set[str]] = {}
    for _, var, rhs, _ in model.assigns:
        m = re.search(r"PySequence_Fast_GET_SIZE\s*\(\s*([A-Za-z_]\w*)", rhs)
        if m is not None:
            sizevars.setdefault(m.group(1), set()).add(var)
    for s, text, _ in model.texts:
        for m in re.finditer(
                r"PySequence_Fast_(?:GET_ITEM|ITEMS)\s*\(\s*([A-Za-z_]\w*)",
                text):
            target = m.group(1)
            if target in param_objs:
                continue
            if target not in fastvars:
                yield _f("NAT004", relpath, s.line, fn.name,
                         f"unvalidated-fast:{target}",
                         f"PySequence_Fast_GET_ITEM on '{target}', which "
                         f"never went through PySequence_Fast() — a "
                         f"non-list/tuple argument reads wild memory")
                continue
            guarded = any(
                d.kind in _COND_KINDS and (
                    f"PySequence_Fast_GET_SIZE ( {target}" in d.text
                    or any(_mentions_plain(d.text, sv)
                           for sv in sizevars.get(target, ())))
                for d in model.dominating(s))
            if not guarded:
                yield _f("NAT004", relpath, s.line, fn.name,
                         f"unbounded-fast:{target}",
                         f"PySequence_Fast_GET_ITEM on '{target}' with no "
                         f"dominating PySequence_Fast_GET_SIZE bound — "
                         f"the index can run past the item array")
    # -- Py_buffer-derived raw pointers ----------------------------------
    bufvars = [m.group(1) for _, text, _ in model.texts
               for m in [re.search(r"\bPy_buffer\s+([A-Za-z_]\w*)", text)]
               if m is not None]
    if not bufvars:
        return
    aliases: set[str] = set()      # integer size aliases of any buffer
    derived: set[str] = set()      # pointers derived from any .buf
    for _, var, rhs, _ in model.assigns:
        if any(re.search(rf"\b{bv}\s*\.\s*len\b", rhs) for bv in bufvars):
            aliases.add(var)
        if any(re.search(rf"\b{bv}\s*\.\s*buf\b", rhs) for bv in bufvars):
            derived.add(var)
        elif "[" not in rhs and any(
                re.match(rf"^(?:\(\s*[\w\s\*]+?\s*\)\s*)*{dv}\b", rhs)
                for dv in list(derived)):
            derived.add(var)
    for s, text, is_cond in model.texts:
        used = [dv for dv in derived
                if (re.search(rf"\bmemcpy\s*\(", text)
                    and _mentions_plain(text, dv))
                or re.search(rf"\b{dv}\s*\[", text)]
        if not used or is_cond:
            continue
        for dv in used:
            guard = any(
                d.kind in _COND_KINDS and (
                    any(re.search(rf"\b{bv}\s*\.\s*len\b", d.text)
                        for bv in bufvars)
                    or any(_mentions_plain(d.text, a) for a in aliases)
                    or (_mentions_plain(d.text, dv)
                        and re.search(r"[<>]", d.text)))
                for d in model.dominating(s))
            if not guard:
                yield _f("NAT004", relpath, s.line, fn.name,
                         f"unguarded-buffer:{dv}",
                         f"raw access through '{dv}' (derived from a "
                         f"Py_buffer) with no dominating bounds check "
                         f"against the buffer length — a short input "
                         f"reads past the mapped region")


def _check_gil(models: list[_FnModel], relpath: str) -> Iterable[Finding]:
    bulk: set[str] = set()
    for model in models:
        fn = model.fn
        if not fn.static:
            continue
        ptr = any("*" in p.type and ("char" in p.type or "uint8_t" in p.type)
                  for p in fn.params)
        sizes = [p.name for p in fn.params
                 if "*" not in p.type
                 and re.search(r"\b(size_t|Py_ssize_t)\b", p.type)]
        if not ptr or not sizes:
            continue
        body = " ".join(s.text for s in fn.flat)
        if re.search(r"\bPy\w+", body):
            continue
        if any(s.is_loop and any(_mentions_plain(s.text, sz)
                                 for sz in sizes)
               for s in fn.flat):
            bulk.add(fn.name)
    for model in models:
        fn = model.fn
        if not any("PyObject" in p.type for p in fn.params):
            continue
        has_window = any(GIL_WINDOW in s.text for s in fn.flat)
        if has_window:
            continue
        for s, text, _ in model.texts:
            for helper in bulk:
                if re.search(rf"\b{helper}\s*\(", text):
                    yield _f("NAT006", relpath, s.line, fn.name,
                             f"gil:{helper}",
                             f"{helper}() loops over a caller-supplied "
                             f"byte length with the GIL held and no "
                             f"Py_BEGIN_ALLOW_THREADS window in "
                             f"{fn.name}() — a large input stalls every "
                             f"other thread for the whole pass")


def _check_decoded_counts(model: _FnModel, relpath: str
                          ) -> Iterable[Finding]:
    fn = model.fn
    decoded: dict[str, csource.Stmt] = {}
    for s, text, _ in model.texts:
        m = re.search(r"\bmemcpy\s*\(\s*&\s*([A-Za-z_]\w*)\s*,", text)
        if m is not None:
            decoded.setdefault(m.group(1), s)
        for cm in re.finditer(r"\b\w*varint\w*\s*\(", text):
            args = _call_args(text, cm.end() - 1)
            # out-params beyond the first argument are decode targets
            # (rb_varint(&r, &n)); the write side (wb_varint(&w, v))
            # passes plain values there and captures nothing
            for arg in args[1:]:
                am = re.match(r"^\s*&\s*([A-Za-z_]\w*)\s*$", arg)
                if am is not None:
                    decoded.setdefault(am.group(1), s)
    if not decoded:
        return
    for s, text, is_cond in model.texts:
        if is_cond:
            continue
        for var, src in decoded.items():
            if not any(re.search(rf"\b{sink}\s*\([^;]*\b{var}\b", text)
                       for sink in SIZE_SINK_FNS):
                continue
            if not fn.dominates(src, s):
                continue
            validated = any(
                d.kind in ("if", "while") and d is not src
                and _mentions_plain(d.text, var)
                for d in model.dominating(s))
            if not validated:
                yield _f("NAT007", relpath, s.line, fn.name,
                         f"decoded:{var}",
                         f"'{var}' is decoded from the input buffer "
                         f"(line {src.line}) and used as an allocation "
                         f"size with no dominating validation — a "
                         f"corrupt count allocates unbounded memory "
                         f"before any CRC/length check can reject it")


def _check_schemas(source: str, relpath: str,
                   fns: list[csource.CFunction]) -> Iterable[Finding]:
    def symbol_at(line: int) -> str:
        for fn in fns:
            last = max((s.line for s in fn.flat), default=fn.line)
            if fn.line <= line <= last:
                return fn.name
        return "<file>"

    for schema in parse_c_schemas(source):
        if schema.emit_count is not None \
                and schema.emit_count != len(schema.fields):
            yield _f("NAT005", relpath, schema.line, symbol_at(schema.line),
                     f"schema-count:{schema.name}",
                     f"schema comment for {schema.name} lists "
                     f"{len(schema.fields)} field(s) but the struct emit "
                     f"that follows hard-codes {schema.emit_count} — the "
                     f"comment and the wire bytes have drifted apart")
    claimed: set[int] = set()
    for cm in _C_COMMENT_RE.finditer(source):
        for sm in _C_SCHEMA_RE.finditer(cm.group(0)):
            if sm is None:
                continue
            em = _C_EMIT_RE.search(source, cm.end(), cm.end() + 2500)
            if em is not None:
                claimed.add(em.start())
    for em in _C_EMIT_RE.finditer(source):
        if em.start() in claimed:
            continue
        line = source.count("\n", 0, em.start()) + 1
        yield _f("NAT005", relpath, line, symbol_at(line),
                 "undocumented-emit",
                 f"'R' struct emit with field count {em.group(1)} has no "
                 f"schema comment in the preceding window — PROTO005 "
                 f"cannot cross-check it against the Python dataclass")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def analyze_c_source(source: str, relpath: str = C_RELPATH
                     ) -> list[Finding]:
    """Run every NAT rule over one C translation unit. Tests feed fixture
    snippets and mutated copies of the real file here; the registered rules
    below feed the real file."""
    fns = csource.parse_functions(source)
    models = [_FnModel(fn) for fn in fns]
    findings: list[Finding] = []
    for model in models:
        findings.extend(_check_alloc(model, relpath))
        findings.extend(_check_refcounts(model, relpath))
        findings.extend(_check_fallible(model, relpath))
        findings.extend(_check_buffers(model, relpath))
        findings.extend(_check_decoded_counts(model, relpath))
    findings.extend(_check_gil(models, relpath))
    findings.extend(_check_schemas(source, relpath, fns))
    supp = csource.suppressions(csource.tokenize(source))
    findings = [f for f in findings
                if not _suppressed(supp, f.line, f.rule)]
    findings.sort(key=lambda f: (f.line, f.rule, f.detail))
    return findings


def _suppressed(supp: dict[int, set[str]], line: int, rule: str) -> bool:
    codes = supp.get(line, ())
    return "all" in codes or rule in codes


def c_source_path() -> str | None:
    """The real extension source, located from the installed package (same
    resolution as protolint's PROTO005)."""
    from foundationdb_tpu_torch.analysis import flowlint
    path = os.path.join(flowlint.default_target(), "native", "fdb_native.c")
    return path if os.path.exists(path) else None


def _package_findings(pkg) -> list[Finding]:
    """One shared analysis per run, cached on the PackageContext like
    devlint's fixpoint; each registered rule filters its own code."""
    cached = pkg.caches.get("natlint")
    if cached is not None:
        return cached
    findings: list[Finding] = []
    # only analyze the real file when the run actually targets the package
    # (snippet runs in other families' tests must not see C findings)
    if "foundationdb_tpu_torch/native/__init__.py" in pkg.by_relpath:
        path = c_source_path()
        if path is not None:
            with open(path, encoding="utf-8") as f:
                findings = analyze_c_source(f.read())
    pkg.caches["natlint"] = findings
    return findings


class _NatRule(Rule):
    def check_package(self, pkg) -> Iterable[Finding]:
        return [f for f in _package_findings(pkg) if f.rule == self.code]


@register
class UncheckedAllocation(_NatRule):
    code = "NAT001"
    summary = ("allocation results (malloc/PyMem_*/PyBytes_FromStringAndSize"
               ") must be NULL-tested before first use")


@register
class ErrorPathRefBalance(_NatRule):
    code = "NAT002"
    summary = ("every goto-ladder / early-return error path must release "
               "exactly the owned references acquired so far")


@register
class UncheckedFallibleCall(_NatRule):
    code = "NAT003"
    summary = ("fallible CPython calls must have their error return tested "
               "(PyLong_As* additionally via PyErr_Occurred/-1)")


@register
class UnboundedBufferAccess(_NatRule):
    code = "NAT004"
    summary = ("raw memcpy/pointer access on Py_buffer-derived pointers and "
               "PySequence_Fast items needs a dominating bounds check")


@register
class WireStructEmitParity(_NatRule):
    code = "NAT005"
    summary = ("wire-struct emits must match their PROTO005 schema comments "
               "(field count) and every 'R' emit must carry one")


@register
class GilAcrossBulkLoop(_NatRule):
    code = "NAT006"
    summary = ("pure-C bulk loops over caller-supplied lengths need a "
               "Py_BEGIN_ALLOW_THREADS window in their Python entry point")


@register
class TrustedDecodedCount(_NatRule):
    code = "NAT007"
    summary = ("counts decoded from input buffers must be validated before "
               "sizing an allocation")
