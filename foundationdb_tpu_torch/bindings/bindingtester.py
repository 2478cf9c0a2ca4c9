"""Mini binding conformance tester: a seeded stack machine diffing clients.

Reference: bindings/bindingtester/bindingtester.py + spec/bindingApiTester.md
— the conformance harness every binding must pass: a deterministic random
instruction stream is executed by two independent client implementations as a
stack machine (operands pushed, operations consume/push, errors pushed as
values), each against its own key prefix; afterwards the result stacks AND
the database contents under each prefix must be identical.

Here the two implementations are:
  - the C-ABI-shaped surface (bindings/fdb_c.py — handle/future/error-code
    semantics on a network thread), and
  - the native async client (client/transaction.py driven on its own loop),
so the tester cross-checks the flat ABI's future extraction, error mapping
and RYW behavior against the first-class API.
"""

from __future__ import annotations

import random

from foundationdb_tpu_torch.utils.errors import FDBError

OPS = ("PUSH_SET", "CLEAR", "CLEAR_RANGE", "ATOMIC_ADD", "GET", "GET_KEY",
       "GET_RANGE", "GET_READ_VERSION", "COMMIT", "RESET", "NEW_TRANSACTION")
_WEIGHTS = (30, 8, 4, 10, 22, 5, 8, 3, 8, 1, 1)
N_KEYS = 40


def gen_ops(seed: int, n: int) -> list[tuple]:
    """Deterministic instruction stream; operands are key INDICES so both
    machines rebuild identical keys under their own prefixes."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        op = rng.choices(OPS, weights=_WEIGHTS)[0]
        if op == "PUSH_SET":
            ops.append((op, rng.randrange(N_KEYS),
                        b"v%08d" % rng.randrange(1 << 24)))
        elif op in ("CLEAR", "GET"):
            ops.append((op, rng.randrange(N_KEYS)))
        elif op == "CLEAR_RANGE":
            i = rng.randrange(N_KEYS - 1)
            ops.append((op, i, rng.randrange(i + 1, N_KEYS)))
        elif op == "ATOMIC_ADD":
            ops.append((op, rng.randrange(N_KEYS), rng.randrange(1, 1000)))
        elif op == "GET_KEY":
            ops.append((op, rng.randrange(N_KEYS), rng.choice([False, True]),
                        rng.choice([0, 1, 1, 2])))
        elif op == "GET_RANGE":
            i = rng.randrange(N_KEYS - 1)
            ops.append((op, i, rng.randrange(i + 1, N_KEYS),
                        rng.choice([0, 0, 5]), rng.choice([False, True])))
        else:
            ops.append((op,))
    ops.append(("COMMIT",))
    return ops


class CApiMachine:
    """Executes the stream through the C-ABI surface (fdb_c.py)."""

    def __init__(self, database, prefix: bytes):
        self.db = database
        self.prefix = prefix
        self.tr = database.create_transaction()
        self.stack: list = []

    def key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    def _strip(self, k: bytes) -> bytes:
        # selector resolution may legitimately walk OUT of the tester's
        # prefix (each machine has different neighbors there): normalize
        # every out-of-prefix result to a shared sentinel, like the
        # reference tester's strinc()-clamped selector ranges
        if k.startswith(self.prefix):
            return k[len(self.prefix):]
        return b"<out>"

    def run(self, ops: list[tuple]):
        from foundationdb_tpu_torch.utils.types import MutationType
        for op in ops:
            kind = op[0]
            if kind == "PUSH_SET":
                self.tr.set(self.key(op[1]), op[2])
            elif kind == "CLEAR":
                self.tr.clear(self.key(op[1]))
            elif kind == "CLEAR_RANGE":
                self.tr.clear_range(self.key(op[1]), self.key(op[2]))
            elif kind == "ATOMIC_ADD":
                self.tr.atomic_op(self.key(op[1]),
                                  op[2].to_bytes(8, "little"),
                                  int(MutationType.ADD_VALUE))
            elif kind == "GET":
                err, present, v = self.tr.get(self.key(op[1])).get_value()
                self.stack.append(("get", err, present, v))
            elif kind == "GET_KEY":
                err, k = self.tr.get_key(self.key(op[1]), op[2],
                                         op[3]).get_key()
                self.stack.append(("key", err,
                                   self._strip(k) if k is not None else k))
            elif kind == "GET_RANGE":
                err, rows, _more = self.tr.get_range(
                    self.key(op[1]), self.key(op[2]), limit=op[3],
                    reverse=op[4]).get_keyvalue_array()
                norm = (tuple((self._strip(k), v) for k, v in rows)
                        if rows is not None else None)
                self.stack.append(("range", err, norm))
            elif kind == "GET_READ_VERSION":
                err, _v = self.tr.get_read_version().get_version()
                self.stack.append(("grv", err, _v is not None and _v > 0))
            elif kind == "COMMIT":
                err = self.tr.commit().get_error()
                self.stack.append(("commit", err))
                self.tr.reset()
            elif kind == "RESET":
                self.tr.reset()
            elif kind == "NEW_TRANSACTION":
                self.tr = self.db.create_transaction()

    def final_rows(self):
        tr = self.db.create_transaction()
        err, rows, _m = tr.get_range(self.prefix, self.prefix + b"\xff",
                                     limit=0).get_keyvalue_array()
        assert err == 0, err
        return [(self._strip(k), v) for k, v in rows]


class NativeMachine:
    """Executes the stream through the native async client on `loop`."""

    def __init__(self, loop, database, prefix: bytes):
        self.loop = loop
        self.db = database
        self.prefix = prefix
        self.tr = database.create_transaction()
        self.stack: list = []

    def key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    def _strip(self, k: bytes) -> bytes:
        if k.startswith(self.prefix):
            return k[len(self.prefix):]
        return b"<out>"

    def _wait(self, coro):
        return self.loop.run_future(self.loop.spawn(coro, name="btNative"),
                                    max_time=60.0)

    def run(self, ops: list[tuple]):
        from foundationdb_tpu_torch.server.interfaces import KeySelector
        from foundationdb_tpu_torch.utils.errors import error_code
        from foundationdb_tpu_torch.utils.types import MutationType
        for op in ops:
            kind = op[0]
            if kind == "PUSH_SET":
                self.tr.set(self.key(op[1]), op[2])
            elif kind == "CLEAR":
                self.tr.clear(self.key(op[1]))
            elif kind == "CLEAR_RANGE":
                self.tr.clear_range(self.key(op[1]), self.key(op[2]))
            elif kind == "ATOMIC_ADD":
                self.tr.atomic_op(MutationType.ADD_VALUE, self.key(op[1]),
                                  op[2].to_bytes(8, "little"))
            elif kind == "GET":
                try:
                    v = self._wait(self.tr.get(self.key(op[1])))
                    self.stack.append(("get", 0, v is not None, v))
                except FDBError as e:
                    self.stack.append(("get", error_code(e.name), False, None))
            elif kind == "GET_KEY":
                sel = KeySelector(key=self.key(op[1]), or_equal=op[2],
                                  offset=op[3])
                try:
                    k = self._wait(self.tr.get_key(sel))
                    self.stack.append(("key", 0,
                                       self._strip(k) if k is not None else k))
                except FDBError as e:
                    self.stack.append(("key", error_code(e.name), None))
            elif kind == "GET_RANGE":
                try:
                    rows = self._wait(self.tr.get_range(
                        self.key(op[1]), self.key(op[2]), limit=op[3],
                        reverse=op[4]))
                    self.stack.append(
                        ("range", 0,
                         tuple((self._strip(k), v) for k, v in rows)))
                except FDBError as e:
                    self.stack.append(("range", error_code(e.name), None))
            elif kind == "GET_READ_VERSION":
                try:
                    v = self._wait(self.tr.get_read_version())
                    self.stack.append(("grv", 0, v > 0))
                except FDBError as e:
                    self.stack.append(("grv", error_code(e.name), False))
            elif kind == "COMMIT":
                try:
                    self._wait(self.tr.commit())
                    self.stack.append(("commit", 0))
                except FDBError as e:
                    self.stack.append(("commit", error_code(e.name)))
                self.tr.reset()
            elif kind == "RESET":
                self.tr.reset()
            elif kind == "NEW_TRANSACTION":
                self.tr = self.db.create_transaction()

    def final_rows(self):
        async def read(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff")
        rows = self._wait(self.db.transact(read))
        return [(self._strip(k), v) for k, v in rows]


def compare_runs(seed: int, n_ops: int, capi_db, native_loop, native_db,
                 prefix_c: bytes = b"bt_c/",
                 prefix_n: bytes = b"bt_n/") -> int:
    """Run the identical stream through both machines; raise on ANY
    divergence in the result stacks or the final database contents.
    Returns the number of stack entries compared."""
    ops = gen_ops(seed, n_ops)
    mc = CApiMachine(capi_db, prefix_c)
    mn = NativeMachine(native_loop, native_db, prefix_n)
    mc.run(ops)
    mn.run(ops)
    assert len(mc.stack) == len(mn.stack), \
        f"stack sizes diverge: {len(mc.stack)} vs {len(mn.stack)}"
    for i, (a, b) in enumerate(zip(mc.stack, mn.stack)):
        assert a == b, f"stack[{i}] diverges:\n  capi  {a}\n  native{b}"
    rc = mc.final_rows()
    rn = mn.final_rows()
    assert rc == rn, \
        (f"final database contents diverge: {len(rc)} vs {len(rn)} rows; "
         f"first diff {next(((x, y) for x, y in zip(rc, rn) if x != y), None)}")
    return len(mc.stack)
