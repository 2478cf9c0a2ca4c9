"""K6's sample sort, planned and partitioned on the CPU.

`kernels.sort_plan(M, L)` picks K6's path and sizes its buckets; a numpy
model of the sample path's partition (tiles sorted, regular samples ranked,
splitters, each run's count at or below each splitter, buckets at the
column sums) holds every bucket to the plan's cap on adversarial inputs,
shows the cap is reached, and puts the buckets together into the plain
sort's order. The plan's constants are read from the kernel's source.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels

TILE = kernels.SORT_TILE
SIZES = (16_384, 65_536, 131_072, 524_294)


def _source_defines(path):
    """The integer #defines of a kernel source, macros expanded."""
    text = path.read_text()
    raw = dict(re.findall(r"^#define (\w+) +(.+?)(?: *//.*)?$", text, re.M))
    out = {}
    for name, expr in raw.items():
        expr = expr.replace("/", "//")
        for other in sorted(out, key=len, reverse=True):
            expr = re.sub(rf"\b{other}\b", str(out[other]), expr)
        try:
            out[name] = int(eval(expr, {}))
        except (NameError, SyntaxError):
            pass
    return out


def total_ranks(keys: np.ndarray, NR: int) -> np.ndarray:
    """Each endpoint's rank in the total order (limbs, class, index)."""
    L, M = keys.shape
    j = np.arange(M)
    cls = np.where((j >= NR) & (j < 2 * NR), 0, 2)
    order = np.lexsort((j, cls, *keys[::-1]))
    ranks = np.empty(M, np.int64)
    ranks[order] = j
    return ranks


def partition(keys: np.ndarray, NR: int, samples: int):
    """The sample path's partition, as the kernel makes it: (bucket sizes,
    bucket offsets, counts (P, P), each bucket's endpoints in order).
    Padding past M ranks after every endpoint, by its virtual index."""
    L, M = keys.shape
    P = -(-M // TILE)
    g = TILE // samples
    rank = total_ranks(keys, NR)
    runs = []  # each tile's ranks, sorted (padding: M + virtual index)
    for i in range(P):
        r = np.sort(rank[i * TILE:(i + 1) * TILE])
        pad = M + i * TILE + np.arange(len(r), TILE)
        runs.append(np.concatenate([r, pad]))
    samp = np.stack([run[g - 1::g] for run in runs])  # (P, s)
    # each sample ranked against every other tile's sorted list
    srank = np.zeros_like(samp)
    for t in range(P):
        srank += np.searchsorted(samp[t], samp, side="left")
    assert sorted(srank.ravel().tolist()) == list(range(P * samples))
    splitters = np.empty(P - 1, np.int64)
    for b in range(P):
        for k in range(samples):
            r = int(srank[b, k]) + 1
            if r % samples == 0 and r != P * samples:
                splitters[r // samples - 1] = samp[b, k]
    counts = np.empty((P, P), np.int64)  # run i's endpoints <= splitter j
    for i in range(P):
        real = runs[i][runs[i] < M]
        counts[i, :P - 1] = np.searchsorted(real, splitters, side="right")
        counts[i, P - 1] = len(real)
    lo = np.concatenate([np.zeros((P, 1), np.int64), counts[:, :-1]], 1)
    sizes = (counts - lo).sum(axis=0)
    offsets = lo.sum(axis=0)
    buckets = [np.sort(np.concatenate([runs[i][lo[i, b]:counts[i, b]]
                                       for i in range(P)]))
               for b in range(P)]
    return sizes, offsets, counts, buckets


def model_samples(M: int, L: int) -> int:
    """The sample path's samples a tile, or the fewest it takes where it
    cannot hold the shape (the bound holds for any)."""
    return kernels.sort_samples(M, L) or kernels.SORT_MIN_SAMPLES


def adversarial_keys(kind: str, M: int, L: int = 5) -> np.ndarray:
    rng = np.random.default_rng(M % 1000 + len(kind))
    keys = np.full((L, M), 9, np.int32)
    if kind == "equal":  # every key the same: class and index decide
        return keys
    if kind in ("sorted", "reversed"):
        v = np.sort(rng.integers(-2 ** 31, 2 ** 31, M)).astype(np.int32)
        keys[0] = v if kind == "sorted" else v[::-1]
        return keys
    if kind == "zipf":  # few hot keys, repeated all over
        keys[0] = (rng.zipf(1.3, M) % 5000).astype(np.int32)
        return keys
    if kind == "prefix":  # the first 4 bytes shared, as YCSB's "user" keys
        keys[0] = 0x75736572 - 2 ** 31
        keys[1] = rng.integers(0, 400, M).astype(np.int32)
        keys[2] = rng.integers(0, 4, M).astype(np.int32)
        return keys
    if kind == "sawtooth":  # each tile sorted, every tile alike
        keys[0] = (np.arange(M) % TILE).astype(np.int32)
        return keys
    raise KeyError(kind)


KINDS = ("equal", "sorted", "reversed", "zipf", "prefix", "sawtooth")


def test_sort_plan_constants_are_the_kernels():
    d = _source_defines(kernels.CSRC_DIR / "endpoint_sort.cu")
    assert d["SORT_TILE"] == kernels.SORT_TILE
    assert d["SS_MAX_SAMPLES"] == kernels.SORT_MAX_SAMPLES
    assert d["SS_MIN_SAMPLES"] == kernels.SORT_MIN_SAMPLES
    assert d["SS_SAMPLE_BUDGET"] == kernels.SORT_SAMPLE_BUDGET
    assert d["SS_SMEM_MAX"] == kernels.SORT_SMEM_MAX <= 232_448
    text = (kernels.CSRC_DIR / "endpoint_sort.cu").read_text()
    # the source's cap and shared memory are the plan's formulas
    assert "return (s + P - 1) * (SORT_TILE / s) - P + 1;" in text
    assert "(long long)(L + 8) * ss_cap(P, s) + 2 * P + 1" in text
    assert "2 * ns + s" in text


EDGE = (kernels.SORT_SAMPLE_MIN_TILES - 1) * TILE  # the last rounds' M


@pytest.mark.parametrize("M,L,path,samples", [
    (1, 5, "tile", 0), (1024, 7, "tile", 0), (1025, 7, "rounds", 64),
    (EDGE, 5, "rounds", 64), (EDGE + 1, 5, "sample", 64),
    (16_384, 7, "rounds", 64), (65_536, 5, "sample", 64),
    (131_072, 5, "sample", 64), (32_768, 17, "sample", 64),
    (32_768, 32, "rounds", 0), (65_536, 32, "rounds", 0),
    (131_072, 17, "rounds", 0), (135_169, 5, "rounds", 0),
    (524_294, 5, "rounds", 0)])
def test_sort_plan_paths(M, L, path, samples):
    # `samples`: what the sample path would take (sort_samples); the plan
    # takes it from SORT_SAMPLE_MIN_TILES tiles up
    assert kernels.sort_samples(M, L) == samples
    plan = kernels.sort_plan(M, L)
    assert plan["path"] == path
    assert plan["samples"] == (samples if path == "sample" else 0)
    assert plan["tiles"] == -(-M // TILE)
    if path == "sample":
        assert plan["launches"] == 1 and plan["grid_barriers"] == 3
        assert plan["tie_limit"] == M // kernels.SORT_TIE_DIV
        assert plan["buckets"] == plan["tiles"] <= 132
        assert plan["tiles"] * samples <= kernels.SORT_SAMPLE_BUDGET
        assert plan["smem_bytes"] <= kernels.SORT_SMEM_MAX
        assert plan["cap"] == kernels.sort_cap(plan["tiles"], samples)
    else:
        assert plan["launches"] == 1
        assert plan["grid_barriers"] == (plan["tiles"] - 1).bit_length()
    # fewer SMs than tiles: the rounds path
    if path == "sample":
        assert kernels.sort_plan(M, L, sms=plan["tiles"] - 1)["path"] == \
            "rounds"


@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_no_bucket_exceeds_the_cap(kind, M):
    L = 5
    s = model_samples(M, L)
    keys = adversarial_keys(kind, M, L)
    sizes, offsets, _counts, _b = partition(keys, M // 4, s)
    P = -(-M // TILE)
    assert sizes.sum() == M
    assert sizes.max() <= kernels.sort_cap(P, s)
    assert (offsets == np.concatenate([[0], np.cumsum(sizes)[:-1]])).all()


@pytest.mark.parametrize("M,L", [(4096, 5), (16_384, 17), (9214, 32),
                                 (65_536, 5)])
@pytest.mark.parametrize("short", [0, 1])
def test_worst_keys_fill_a_bucket_to_the_cap(M, L, short):
    # the cap is a bound that inputs reach: chip_smoke.sort_worst_keys
    s = kernels.sort_samples(M, L)
    keys = chip_smoke.sort_worst_keys(M, L, short, seed=M + L)
    sizes, *_ = partition(keys, M // 4, s)
    assert sizes[0] == sizes.max() == kernels.sort_cap(-(-M // TILE), s) - \
        short
    assert kernels.sort_plan(M, L, samples=s)["cap"] == \
        kernels.sort_cap(-(-M // TILE), s)


@pytest.mark.parametrize("kind", ("zipf", "prefix", "reversed"))
def test_buckets_at_their_offsets_are_the_plain_sort(kind):
    # the kernel's output: each bucket's endpoints in order at its offset
    M, L = 16_384 + 6, 5
    keys = adversarial_keys(kind, M, L)
    NR = M // 4
    _s, offsets, _c, buckets = partition(keys, NR, model_samples(M, L))
    order = np.concatenate(buckets)
    assert (order == np.arange(M)).all()
    assert all(len(b) == 0 or b[0] == o for b, o in zip(buckets, offsets))
    NW = M // 2 - NR
    ends = torch.split(torch.from_numpy(keys), [NR, NR, NW, NW], dim=1)
    ekeys, eidx = ref.endpoint_sort(*(e.contiguous() for e in ends))
    rank = total_ranks(keys, NR)
    assert (rank[eidx.numpy()] == order).all()
    assert (ekeys.numpy() == keys[:, eidx.numpy()]).all()


def test_endpoint_sort_wrapper_runs_the_plain_version_on_cpu():
    keys = torch.from_numpy(adversarial_keys("zipf", 4096 + 8))
    ends = torch.split(keys, [1026, 1026, 1026, 1026], dim=1)
    ends = tuple(e.contiguous() for e in ends)
    kernels.reset_launches()
    got = chip_smoke.forced_sort(*ends, samples=64)
    want = ref.endpoint_sort(*ends)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES["endpoint_sort"] == 0


@pytest.mark.parametrize("kind,turns", [("sorted", False),
                                        ("reversed", False),
                                        ("sawtooth", False),
                                        ("equal", True), ("zipf", True)])
def test_tie_limit_turns_skewed_keys_to_the_rounds(kind, turns):
    # the sample path's kernel turns to the merge rounds where its runs'
    # primary-key ties (chip_smoke.sort_ties, the count it makes) pass the
    # plan's limit: keys that repeat, not keys that are only ordered
    M, L = 65_536, 5
    plan = kernels.sort_plan(M, L)
    assert plan["path"] == "sample"
    assert plan["tie_limit"] == M // kernels.SORT_TIE_DIV
    ties = chip_smoke.sort_ties(adversarial_keys(kind, M, L))
    assert (ties > plan["tie_limit"]) == turns


def test_sort_ties_counts_repeats_of_the_primary_key():
    # one tile: limb 0 shared, so the primary key is limbs 1 and 2; keys
    # that differ only in limb 3 tie, and so do equal keys
    keys = np.zeros((4, 8), np.int32)
    keys[1] = [5, 5, 5, 1, 2, 2, 9, 0]
    keys[3] = [0, 1, 0, 0, 0, 0, 0, 0]
    assert chip_smoke.sort_ties(keys) == 3
    # a second tile counts on its own primary key (limb 0 varies there)
    two = np.zeros((4, TILE + 4), np.int32)
    two[0, TILE:] = [1, 1, 2, 3]
    assert chip_smoke.sort_ties(two) == (TILE - 1) + 1


@pytest.mark.parametrize("tiles", [16, 128])
def test_tied_keys_ties_grow_with_their_share(tiles):
    # the timed sweep's inputs (chip_smoke.tied_keys): the tie count rises
    # with the share of hot copies, from none at 0
    M = tiles * TILE
    ties = [chip_smoke.sort_ties(chip_smoke.tied_keys(M, 5, share, tiles))
            for share in (0, 1 / 64, 1 / 32, 1 / 16, 1 / 8, 1 / 4)]
    assert ties[0] == 0
    assert all(a < b for a, b in zip(ties, ties[1:]))
