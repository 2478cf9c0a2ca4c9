"""The plain reference against hand-built cases, and the generator's
draws (CPU only; run with `python -m pytest kvbench/`)."""

import numpy as np
import pytest

from kvbench import gen
from kvbench import reference as ref
from kvbench.reference import COMMITTED as C
from kvbench.reference import CONFLICT as X
from kvbench.reference import TOO_OLD as O

KEYS = [b"a", b"b", b"c", b"d", b"e", b"f"]
A, B, Cc, D, E, F = range(6)


def stream(reads, writes, snapshots, step=10, window=1000):
    """A pool from per-batch lists of per-txn (begin, end) key ids."""
    def arr(x):
        return np.array(x, dtype=np.int32)
    r, w = arr(reads), arr(writes)
    return gen.Stream(keys=KEYS, rb=r[..., 0], re=r[..., 1], wb=w[..., 0],
                      we=w[..., 1], snapshot=np.array(snapshots, np.int64),
                      versions=step * np.arange(1, len(reads) + 1),
                      step=step, window=window)


def first_pass(s):
    out, _loop = ref.pass_verdicts(s, 1)
    return out[0].tolist()


def test_history_conflict_needs_a_newer_committed_write():
    # batch 0 (v10): t0 writes a. batch 1 (v20): t0 reads a at 5 (a@10 is
    # newer: conflict), t1 reads a at 10 (not newer: commits)
    s = stream(reads=[[[(E, F)], [(E, F)]], [[(A, B)], [(A, B)]]],
               writes=[[[(A, B)], [(D, E)]], [[(Cc, D)], [(Cc, D)]]],
               snapshots=[[0, 0], [5, 10]])
    assert first_pass(s) == [[C, C], [X, C]]


def test_earlier_txns_win_inside_a_batch():
    # t0 reads c and writes a; t1 reads a (t0 committed earlier: conflict)
    # and writes c; t2 reads c: t1's write never committed, so t2 commits
    # and writes e; t3 reads b, which t4 (later) writes: a later write never
    # conflicts; t4 reads e, which t2 wrote: conflict
    s = stream(reads=[[[(Cc, D)], [(A, B)], [(Cc, D)], [(B, Cc)], [(E, F)]]],
               writes=[[[(A, B)], [(Cc, D)], [(E, F)], [(D, E)], [(B, Cc)]]],
               snapshots=[[0] * 5])
    assert first_pass(s) == [[C, X, C, C, X]]


def test_ranges_overlap_by_bytes():
    # [a, c) and [b, d) share [b, c); [a, c) and [c, d) share nothing
    s = stream(reads=[[[(E, F)], [(B, D)], [(Cc, D)]]],
               writes=[[[(A, Cc)], [(E, F)], [(A, B)]]],
               snapshots=[[0] * 3])
    assert first_pass(s) == [[C, X, C]]


def test_too_old_below_the_floor_and_its_writes_never_land():
    # window 15: the floor before batch 1 is 10 - 15 = -5, so a read at -6
    # is too old and its write of a never enters the history; before
    # batch 2 the floor is 5, so a read at 4 is too old there
    s = stream(reads=[[[(E, F)], [(E, F)]], [[(Cc, D)], [(Cc, D)]],
                      [[(A, B)], [(E, F)]]],
               writes=[[[(D, E)], [(D, E)]], [[(A, B)], [(B, Cc)]],
                       [[(D, E)], [(D, E)]]],
               snapshots=[[0, 0], [-6, -5], [10, 4]], window=15)
    assert first_pass(s) == [[C, C], [O, C], [C, O]]


def test_blind_writes_are_never_too_old():
    s = gen.Stream(keys=KEYS, rb=np.zeros((1, 2, 0), np.int32),
                   re=np.zeros((1, 2, 0), np.int32),
                   wb=np.array([[[A], [B]]], np.int32),
                   we=np.array([[[B], [Cc]]], np.int32),
                   snapshot=np.array([[-10**6, 0]]),
                   versions=np.array([10]), step=10, window=15)
    assert first_pass(s) == [[C, C]]


def test_passes_carry_history_across_the_rebase():
    # one batch a pass; t0 reads a one batch back and writes a: pass 0
    # commits (empty history), pass 1 sees pass 0's write (conflict),
    # pass 2 sees only what is older than its snapshot (commits), and
    # pass 3 starts with the history pass 1 started with
    s = stream(reads=[[[(A, B)]]], writes=[[[(A, B)]]], snapshots=[[-10]])
    out, loop = ref.pass_verdicts(s, 8)
    assert [v.tolist() for v in out] == [[[C]], [[X]], [[C]]]
    assert loop == 1
    assert [ref.verdicts_of_pass(out, loop, n).tolist() for n in range(5)] \
        == [[[C]], [[X]], [[C]], [[X]], [[C]]]


def test_history_older_than_the_window_is_forgotten_at_the_floor():
    # a write at 10 and a read at 25 of batch 3 (v40, floor 30 - 15 = 15)
    s = stream(reads=[[[(E, F)]], [[(E, F)]], [[(E, F)]], [[(A, B)]]],
               writes=[[[(A, B)]], [[(Cc, D)]], [[(Cc, D)]], [[(D, E)]]],
               snapshots=[[0], [0], [20], [25]], window=15)
    assert first_pass(s) == [[C], [C], [C], [C]]


def test_key_ranks_are_byte_order():
    rng = np.random.default_rng(3)
    keys = [bytes(rng.integers(0, 3, rng.integers(0, 20)).astype(np.uint8))
            for _ in range(3000)] + [b"", b"\x00", b"\x00\x00", b"user1",
                                     b"user1\x00", b"user10"]
    ranks = ref.key_ranks(keys)
    uniq = sorted(set(keys))
    assert ranks.tolist() == [uniq.index(k) for k in keys]


@pytest.mark.parametrize("cell", ["a-1k", "2500", "16k"])
def test_the_generator_is_the_seed_s_and_every_seed_has_the_same_sizes(cell):
    import json
    from pathlib import Path
    root = Path(__file__).resolve().parent
    config = json.loads((root / "configs" / (
        "ycsb-1m.json" if cell == "a-1k" else "skiplisttest.json"))
        .read_text())
    traffic = json.loads((root / "traffic" / f"{cell}.json").read_text())
    traffic.update(pool_batches=3, txns_per_batch=64)
    a = gen.make_stream(config, traffic, 2**31 + 5)
    b = gen.make_stream(config, traffic, 2**31 + 5)
    c = gen.make_stream(config, traffic, 2**31 + 6)
    for name in ("rb", "re", "wb", "we", "snapshot", "versions"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
        assert getattr(a, name).shape == getattr(c, name).shape
    assert a.keys == b.keys
    assert not np.array_equal(a.snapshot, c.snapshot) or \
        not np.array_equal(a.rb, c.rb)


def test_ycsb_keys_are_hashed_user_keys():
    # YCSB's Utils.fnvhash64, written out over Python ints
    def fnv(val):
        h = 0xCBF29CE484222325
        for _ in range(8):
            h = ((h ^ (val & 0xFF)) * 0x100000001B3) % 2**64
            val >>= 8
        return abs(h - 2**64 if h >= 2**63 else h)
    vals = [0, 1, 255, 999999, 2**40 + 7]
    assert gen.fnv64(np.array(vals)).tolist() == [fnv(v) for v in vals]
    keys = gen.record_keys({"prefix": "user", "insertorder": "hashed",
                            "format": "decimal"}, np.arange(1000))
    assert all(k.startswith(b"user") and 5 <= len(k) <= 24 for k in keys)
    assert len(set(keys)) == 1000


def test_skiplisttest_keys_are_dots_then_a_big_endian_int():
    keys = gen.record_keys({"prefix": "." * 12, "format": "be32"},
                           np.array([0, 1, 256, 19999999]))
    assert keys[2] == b"." * 12 + b"\x00\x00\x01\x00"
    assert all(len(k) == 16 for k in keys)
    assert sorted(keys) == keys
