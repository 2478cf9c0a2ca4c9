"""csource: a lightweight C front-end for natlint (no compiler involved).

natlint (the fourth rule family, NAT001..NAT007) reads native/fdb_native.c —
hand-written CPython extension code whose whole failure class is structural:
a `goto err` ladder that releases one ref too few, a `memcpy` off the end of
a Py_buffer, a decoded count trusted before validation. Those properties
live in the *shape* of each function (which statement dominates which, what
a goto ladder releases on the way out), not in the token stream — so this
module builds just enough structure to ask shape questions:

  - tokenize(): comments / strings / chars / identifiers / numbers /
    punctuation, with line numbers; preprocessor lines become single 'pp'
    tokens so `#define` bodies can't unbalance the brace tracking.
  - parse_functions(): top-level function definitions with parsed parameter
    lists and a statement tree per body (if/for/while/do/switch/label/goto/
    return/blocks; everything else is a 'simple' statement of flat text).
  - CFunction: pre-order numbering + block paths for a textual dominance
    relation (A dominates B iff A's enclosing block chain is an ancestor of
    B's and A precedes B), goto-ladder resolution (the statements an error
    exit executes on its way to `return NULL`), and exit enumeration.

The model is deliberately approximate — it is a lint front-end, not a
compiler. The approximations are chosen one-sided where it matters: dominance
never claims an if-branch statement covers code after the join, and ladder
resolution follows fallthrough and chained gotos with a cycle guard. The
fixtures in tests/test_csource.py pin the round-trip on the real
fdb_native.c (every brace balanced, every function found) plus the ladder
shapes the NAT rules depend on.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Object-like CPython macros that appear in statement position WITHOUT a
# trailing semicolon (they expand to `{`-fragments). Anything else that
# looks like a statement must end in ';' or '{'.
BARE_MACROS = ("Py_BEGIN_ALLOW_THREADS", "Py_END_ALLOW_THREADS",
               "Py_BLOCK_THREADS", "Py_UNBLOCK_THREADS")

_PUNCT2 = ("->", "<<", ">>", "<=", ">=", "==", "!=", "&&", "||", "+=",
           "-=", "*=", "/=", "%=", "&=", "|=", "^=", "++", "--")


@dataclass(frozen=True)
class Token:
    kind: str   # 'comment' | 'pp' | 'string' | 'char' | 'ident' | 'num' | 'punct'
    text: str
    line: int


def tokenize(source: str) -> list[Token]:
    """Full-fidelity token stream (comments and preprocessor lines kept as
    their own tokens so suppression scanning and brace tracking both work)."""
    out: list[Token] = []
    i, n, line = 0, len(source), 1
    while i < n:
        c = source[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r\v\f":
            i += 1
            continue
        if c == "/" and i + 1 < n and source[i + 1] == "*":
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(Token("comment", source[i:j], line))
            line += source.count("\n", i, j)
            i = j
            continue
        if c == "/" and i + 1 < n and source[i + 1] == "/":
            j = source.find("\n", i)
            j = n if j < 0 else j
            out.append(Token("comment", source[i:j], line))
            i = j
            continue
        if c == "#" and _at_line_start(source, i):
            j = i
            while j < n:
                k = source.find("\n", j)
                if k < 0:
                    k = n
                if source[j:k].rstrip().endswith("\\"):
                    j = k + 1
                else:
                    break
            k = source.find("\n", j)
            k = n if k < 0 else k
            out.append(Token("pp", source[i:k], line))
            line += source.count("\n", i, k)
            i = k
            continue
        if c in "\"'":
            j = i + 1
            while j < n and source[j] != c:
                if source[j] == "\\":
                    j += 1
                j += 1
            j = min(j + 1, n)
            out.append(Token("string" if c == '"' else "char",
                             source[i:j], line))
            line += source.count("\n", i, j)
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (source[j].isalnum() or source[j] == "_"):
                j += 1
            out.append(Token("ident", source[i:j], line))
            i = j
            continue
        if c.isdigit():
            j = i
            while j < n and (source[j].isalnum() or source[j] in "._"
                             or (source[j] in "+-"
                                 and source[j - 1] in "eEpP")):
                j += 1
            out.append(Token("num", source[i:j], line))
            i = j
            continue
        two = source[i:i + 2]
        if two in _PUNCT2:
            out.append(Token("punct", two, line))
            i += 2
            continue
        out.append(Token("punct", c, line))
        i += 1
    return out


def _at_line_start(source: str, i: int) -> bool:
    j = i - 1
    while j >= 0 and source[j] in " \t":
        j -= 1
    return j < 0 or source[j] == "\n"


def code_tokens(tokens: list[Token]) -> list[Token]:
    """The parse stream: comments and preprocessor lines dropped."""
    return [t for t in tokens if t.kind not in ("comment", "pp")]


def suppressions(tokens: list[Token], marker: str = "natlint:"
                 ) -> dict[int, set[str]]:
    """Inline-suppression map from comment tokens: a comment containing
    `natlint: ignore[NAT004]` (comma lists and `all` accepted) suppresses
    on its own line AND the following line, matching the flowlint
    convention of tagging either the offending line or the line above."""
    import re
    out: dict[int, set[str]] = {}
    for t in tokens:
        if t.kind != "comment" or marker not in t.text:
            continue
        m = re.search(r"ignore\[([^\]]*)\]", t.text.split(marker, 1)[1])
        if m is None:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        last = t.line + t.text.count("\n")
        for ln in (t.line, last, last + 1):
            out.setdefault(ln, set()).update(codes)
    return out


# --------------------------------------------------------------- statements

@dataclass
class Stmt:
    """One statement. `text` is the flat token text: the full statement for
    simple/return/goto, the condition (or for-header) for if/for/while/do/
    switch. Numbering fields are filled by CFunction._number()."""

    kind: str            # simple|if|for|while|do|switch|case|label|goto|
    #                      return|break|continue|block
    line: int
    text: str = ""
    label: str = ""      # label/goto target
    body: list["Stmt"] = field(default_factory=list)
    orelse: list["Stmt"] = field(default_factory=list)
    order: int = -1
    block: tuple = ()
    parent: "Stmt | None" = None
    sibs: "list[Stmt] | None" = None  # the sibling list containing self
    idx: int = -1                     # index within sibs

    @property
    def is_loop(self) -> bool:
        return self.kind in ("for", "while", "do")


def _text(tokens: list[Token]) -> str:
    return " ".join(t.text for t in tokens)


class _Parser:
    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self, k: int = 0) -> Token | None:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def take(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def _balanced(self, opener: str, closer: str) -> list[Token]:
        """Consume from an `opener` token through its matching closer;
        returns the inner tokens."""
        assert self.take().text == opener
        depth, inner = 1, []
        while self.i < len(self.toks):
            t = self.take()
            if t.text == opener:
                depth += 1
            elif t.text == closer:
                depth -= 1
                if depth == 0:
                    return inner
            inner.append(t)
        return inner  # unterminated: best effort

    def parse_block(self) -> list[Stmt]:
        """Parse a `{ ... }` whose opening brace is the current token."""
        assert self.take().text == "{"
        out: list[Stmt] = []
        while self.i < len(self.toks):
            t = self.peek()
            if t is None or t.text == "}":
                if t is not None:
                    self.take()
                return out
            out.append(self.parse_stmt())
        return out

    def _body(self) -> list[Stmt]:
        """A statement body: braced block or single statement."""
        t = self.peek()
        if t is not None and t.text == "{":
            return self.parse_block()
        return [self.parse_stmt()]

    def parse_stmt(self) -> Stmt:  # noqa: C901 — a parser is a switch
        t = self.peek()
        line = t.line
        if t.text == "{":
            return Stmt("block", line, body=self.parse_block())
        if t.kind == "ident":
            kw = t.text
            if kw == "if":
                self.take()
                cond = _text(self._balanced("(", ")"))
                body = self._body()
                orelse: list[Stmt] = []
                nxt = self.peek()
                if nxt is not None and nxt.text == "else":
                    self.take()
                    orelse = self._body()
                return Stmt("if", line, text=cond, body=body, orelse=orelse)
            if kw in ("for", "while"):
                self.take()
                cond = _text(self._balanced("(", ")"))
                return Stmt(kw, line, text=cond, body=self._body())
            if kw == "do":
                self.take()
                body = self._body()
                cond = ""
                nxt = self.peek()
                if nxt is not None and nxt.text == "while":
                    self.take()
                    cond = _text(self._balanced("(", ")"))
                    if self.peek() is not None and self.peek().text == ";":
                        self.take()
                return Stmt("do", line, text=cond, body=body)
            if kw == "switch":
                self.take()
                cond = _text(self._balanced("(", ")"))
                return Stmt("switch", line, text=cond, body=self._body())
            if kw in ("case", "default"):
                taken = [self.take()]
                while self.i < len(self.toks) and self.peek().text != ":":
                    taken.append(self.take())
                if self.i < len(self.toks):
                    self.take()  # ':'
                return Stmt("case", line, text=_text(taken))
            if kw == "goto":
                self.take()
                label = self.take().text
                if self.peek() is not None and self.peek().text == ";":
                    self.take()
                return Stmt("goto", line, label=label,
                            text=f"goto {label}")
            if kw == "return":
                self.take()
                toks = self._until_semi()
                return Stmt("return", line, text=_text(toks))
            if kw in ("break", "continue"):
                self.take()
                if self.peek() is not None and self.peek().text == ";":
                    self.take()
                return Stmt(kw, line)
            if kw in BARE_MACROS:
                self.take()
                if self.peek() is not None and self.peek().text == ";":
                    self.take()
                return Stmt("simple", line, text=kw)
            nxt = self.peek(1)
            if nxt is not None and nxt.text == ":" and kw not in (
                    "default",) and (self.peek(2) is None
                                     or self.peek(2).text != ":"):
                # plain `label:` — ternaries never start a statement with
                # `ident :`, so this is unambiguous at statement position
                self.take()
                self.take()
                return Stmt("label", line, label=kw, text=f"{kw}:")
        toks = self._until_semi()
        return Stmt("simple", line, text=_text(toks))

    def _until_semi(self) -> list[Token]:
        """Consume one simple statement: through the next `;` at zero
        paren/brace depth (brace depth covers `int t[2] = {0, 1};`)."""
        out: list[Token] = []
        depth = 0
        while self.i < len(self.toks):
            t = self.peek()
            if depth == 0 and t.text == ";":
                self.take()
                return out
            if depth == 0 and t.text == "}":
                return out  # missing ';' before block close: don't eat it
            if t.text in "({[":
                depth += 1
            elif t.text in ")}]":
                depth -= 1
            out.append(self.take())
        return out


# --------------------------------------------------------------- functions

@dataclass
class CParam:
    type: str
    name: str


@dataclass
class CFunction:
    name: str
    line: int
    params: list[CParam]
    body: list[Stmt]
    static: bool = False
    return_type: str = ""

    def __post_init__(self):
        self.flat: list[Stmt] = []
        self.by_label: dict[str, Stmt] = {}
        self._number(self.body, (), None)

    def _number(self, stmts: list[Stmt], block: tuple, parent: Stmt | None):
        for idx, s in enumerate(stmts):
            s.order = len(self.flat)
            s.block = block
            s.parent = parent
            s.sibs = stmts
            s.idx = idx
            self.flat.append(s)
            if s.kind == "label":
                self.by_label[s.label] = s
            if s.body:
                self._number(s.body, block + (s.order,), s)
            if s.orelse:
                self._number(s.orelse, block + (-s.order - 1,), s)

    # -- shape queries ----------------------------------------------------

    def dominates(self, a: Stmt, b: Stmt) -> bool:
        """Textual dominance: a's enclosing block chain is an ancestor of
        (or equal to) b's, and a precedes b. Sound for the straight-line +
        structured-branch code this file contains; never lets an if-branch
        statement cover code after the join."""
        if a.order >= b.order:
            return False
        return a.block == b.block[:len(a.block)]

    def ancestors(self, s: Stmt):
        cur = s.parent
        while cur is not None:
            yield cur
            cur = cur.parent

    def ladder(self, label: str, _seen: frozenset = frozenset()
               ) -> list[Stmt]:
        """The statements executed after `goto label`: the label's following
        siblings (bodies flattened), falling through further labels and
        chasing chained gotos, up to and including the terminating return."""
        if label in _seen or label not in self.by_label:
            return []
        lab = self.by_label[label]
        out: list[Stmt] = []
        for s in lab.sibs[lab.idx + 1:]:
            out.extend(_flatten([s]))
            if s.kind == "return":
                return out
            if s.kind == "goto":
                return out + self.ladder(s.label, _seen | {label})
        return out

    def exits(self) -> list[tuple[Stmt, list[Stmt], Stmt | None]]:
        """Every (exit statement, path statements run on the way out,
        terminal return or None). Direct returns have an empty path; gotos
        carry their resolved ladder."""
        out = []
        for s in self.flat:
            if s.kind == "return":
                out.append((s, [], s))
            elif s.kind == "goto":
                path = self.ladder(s.label)
                term = next((p for p in reversed(path)
                             if p.kind == "return"), None)
                out.append((s, path, term))
        return out


def _flatten(stmts: list[Stmt]) -> list[Stmt]:
    out = []
    for s in stmts:
        out.append(s)
        out.extend(_flatten(s.body))
        out.extend(_flatten(s.orelse))
    return out


def _split_params(tokens: list[Token]) -> list[CParam]:
    if not tokens or (len(tokens) == 1 and tokens[0].text == "void"):
        return []
    groups: list[list[Token]] = [[]]
    depth = 0
    for t in tokens:
        if t.text in "([":
            depth += 1
        elif t.text in ")]":
            depth -= 1
        if t.text == "," and depth == 0:
            groups.append([])
        else:
            groups[-1].append(t)
    out = []
    for g in groups:
        idents = [t for t in g if t.kind == "ident"]
        if not idents:
            continue
        name = idents[-1].text
        type_toks = [t.text for t in g[:-1]] if g and g[-1].kind == "ident" \
            else [t.text for t in g if t is not idents[-1]]
        out.append(CParam(type=" ".join(type_toks), name=name))
    return out


def parse_functions(source: str) -> list[CFunction]:
    """Top-level function definitions. The match shape is
    `<type tokens> name ( params ) {` at zero brace depth — initializer
    braces and struct/typedef bodies are skipped wholesale."""
    toks = code_tokens(tokenize(source))
    out: list[CFunction] = []
    i, n = 0, len(toks)
    depth = 0
    while i < n:
        t = toks[i]
        if t.text == "{":
            depth += 1
            i += 1
            continue
        if t.text == "}":
            depth -= 1
            i += 1
            continue
        if depth == 0 and t.kind == "ident" and i + 1 < n \
                and toks[i + 1].text == "(" \
                and i > 0 and (toks[i - 1].kind == "ident"
                               or toks[i - 1].text == "*"):
            # find the matching ')' of the parameter list
            j, d = i + 1, 0
            while j < n:
                if toks[j].text == "(":
                    d += 1
                elif toks[j].text == ")":
                    d -= 1
                    if d == 0:
                        break
                j += 1
            if j + 1 < n and toks[j + 1].text == "{":
                # return type: the declaration tokens before the name
                k = i - 1
                while k >= 0 and (toks[k].kind == "ident"
                                  or toks[k].text == "*"):
                    k -= 1
                decl = [x.text for x in toks[k + 1:i]]
                params = _split_params(toks[i + 2:j])
                # body: parse the brace block starting at j+1
                p = _Parser(toks[j + 1:])
                body = p.parse_block()
                out.append(CFunction(
                    name=t.text, line=t.line, params=params, body=body,
                    static="static" in decl,
                    return_type=" ".join(x for x in decl
                                         if x != "static")))
                i = j + 1 + p.i
                continue
        i += 1
    return out
