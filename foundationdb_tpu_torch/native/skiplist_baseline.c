/* Measured CPU baseline for the north-star conflict engine.
 *
 * A from-scratch single-threaded C implementation of the reference's
 * conflict-detection ALGORITHM (fdbserver/SkipList.cpp): committed write
 * history as a version step function over the keyspace, stored in a skiplist
 * whose per-level max-version annotations prune range-max queries
 * (SkipList.cpp:324-357's level pyramid); batch processing = history check,
 * sorted-endpoint intra-batch check with a two-level bitmask
 * (MiniConflictSet, :1028-1130), merge of surviving writes (covered interior
 * nodes removed, ends inserted — addConflictRanges :511-522), and
 * incremental window GC (removeBefore :665).
 *
 * Workload = skipListTest (:1412-1502) exactly: batches of transactions with
 * 1 read + 1 write range each, keys '.'x12 + 4-byte big-endian int over a
 * 20M keyspace, spans 1..10, read_snapshot = batch index i, detect at
 * version i+50 with window floor i (50 batches of history).
 *
 * This is NOT the reference binary (its actor-compiled build needs a C#
 * toolchain absent here); it is the same algorithm, independently written
 * and tuned (-O3), run on THIS machine — which is what vs_baseline should
 * divide by. Build/run:
 *   cc -O3 -march=native -o skiplist_baseline skiplist_baseline.c
 *   ./skiplist_baseline [txns_per_batch] [n_batches]
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define KEYB 16
#define MAX_LEVEL 28

/* deterministic xorshift PRNG (g_random stand-in) */
static uint64_t rngs = 0x9E3779B97F4A7C15ull;
static inline uint32_t rnd(uint32_t n) {
    rngs ^= rngs << 13;
    rngs ^= rngs >> 7;
    rngs ^= rngs << 17;
    return (uint32_t)(rngs % n);
}

/* ---------------- skiplist: version step function ---------------- */

/* variable-size nodes (the reference's FastAlloc'd level-sized nodes,
 * SkipList.cpp:332-341): key and value share the first cache line, links
 * trail — a 28-level fixed layout was ~470B/node and cache-hostile */
typedef struct Node {
    int32_t level;
    int64_t value; /* version of segment [key, next->key) */
    uint8_t key[KEYB];
    struct Link {
        struct Node *next;
        int64_t maxver; /* max value over [this, next) at this level */
    } ln[];
} Node;

static Node *head;
static int cur_level = 1;

static inline int keycmp(const uint8_t *a, const uint8_t *b) {
    return memcmp(a, b, KEYB);
}

/* FastAlloc-style pools, one per level class: nodes churn constantly
 * (every merge removes interior nodes and inserts two) */
static Node *free_lists[MAX_LEVEL + 1];

static Node *node_new(const uint8_t *key, int level, int64_t value) {
    Node *n = free_lists[level];
    if (n)
        free_lists[level] = n->ln[0].next;
    else
        n = malloc(sizeof(Node) + (size_t)level * sizeof(struct Link));
    n->level = level;
    n->value = value;
    memcpy(n->key, key, KEYB);
    for (int l = 0; l < level; l++) {
        n->ln[l].next = NULL;
        n->ln[l].maxver = value;
    }
    return n;
}

static inline void node_free(Node *n) {
    n->ln[0].next = free_lists[n->level];
    free_lists[n->level] = n;
}

static void sl_init(void) {
    uint8_t zero[KEYB];
    memset(zero, 0, KEYB);
    head = node_new(zero, MAX_LEVEL, INT64_MIN);
    cur_level = 1;
}

static inline int rand_level(void) {
    int l = 1;
    while (l < MAX_LEVEL - 1 && (rnd(2) == 0))
        l++;
    return l;
}

typedef struct {
    uint8_t rb[KEYB], re[KEYB], wb[KEYB], we[KEYB];
} Txn;

/* 16-way interleaved history check (the reference's software-pipelined
 * CheckMax state machines, SkipList.cpp:526-552,:755-837): each query is a
 * small state machine advanced round-robin, one node hop per turn with the
 * next hop prefetched — memory-level parallelism across queries hides the
 * pointer-chase latency that dominates a lone descent. */
#define IWAY 16

typedef struct {
    const uint8_t *b, *e;
    int64_t best;
    Node *x;  /* current node */
    int l;    /* current level (phase 0) */
    int phase; /* 0 = descend to b, 1 = walk to e, 2 = done */
    int out;  /* result slot */
} CMQ;

static void range_max_batch(const Txn *txns, uint8_t *conflict, int T,
                            int64_t snapshot) {
    CMQ q[IWAY];
    int nq = 0, nexti = 0, live = 0;
    for (int s = 0; s < IWAY && nexti < T; s++, nexti++) {
        q[s].b = txns[nexti].rb;
        q[s].e = txns[nexti].re;
        q[s].x = head;
        q[s].l = cur_level - 1;
        q[s].phase = 0;
        q[s].best = INT64_MIN;
        q[s].out = nexti;
        live++;
    }
    nq = live;
    while (live > 0) {
        for (int s = 0; s < nq; s++) {
            CMQ *c = &q[s];
            if (c->phase == 2)
                continue;
            if (c->phase == 0) {
                Node *n = c->x->ln[c->l].next;
                if (n && keycmp(n->key, c->b) <= 0) {
                    c->x = n;
                    __builtin_prefetch(n->ln[c->l].next);
                } else if (--c->l < 0) {
                    c->best = c->x->value;
                    c->phase = 1;
                    c->x = c->x->ln[0].next;
                    if (c->x)
                        __builtin_prefetch(c->x);
                }
                continue;
            }
            /* phase 1: walk segments until e, jumping at the highest level
             * whose landing stays below e */
            Node *y = c->x;
            if (!y || keycmp(y->key, c->e) >= 0) {
                conflict[c->out] = c->best > snapshot;
                if (nexti < T) {
                    c->b = txns[nexti].rb;
                    c->e = txns[nexti].re;
                    c->x = head;
                    c->l = cur_level - 1;
                    c->phase = 0;
                    c->best = INT64_MIN;
                    c->out = nexti++;
                } else {
                    c->phase = 2;
                    live--;
                }
                continue;
            }
            int l = y->level - 1;
            while (l > 0 &&
                   !(y->ln[l].next && keycmp(y->ln[l].next->key, c->e) <= 0))
                l--;
            if (l > 0) {
                if (y->ln[l].maxver > c->best)
                    c->best = y->ln[l].maxver;
                c->x = y->ln[l].next;
            } else {
                if (y->value > c->best)
                    c->best = y->value;
                c->x = y->ln[0].next;
            }
            if (c->x)
                __builtin_prefetch(c->x);
        }
    }
}

/* insert committed range [b, e) at version v (v >= all stored versions):
 * the whole span collapses to one segment — splice out interior nodes per
 * level (addConflictRanges' remove-covered-insert-ends), then insert the
 * begin node at v and an end node restoring the prior covering value.
 * `update` = per-level last-node-before-b fingers (found separately so the
 * searches can be interleaved like the reference's striped find :587). */
/* recompute node `n`'s level-l maxver exactly: the max of the level-(l-1)
 * maxvers of the span's members (maxver[0] == value is exact by
 * construction) */
static void fix_maxver_level(Node *n, int l) {
    int64_t m = n->ln[l - 1].maxver;
    Node *q = n->ln[l - 1].next;
    Node *stop = n->ln[l].next;
    while (q != stop) {
        if (q->ln[l - 1].maxver > m)
            m = q->ln[l - 1].maxver;
        q = q->ln[l - 1].next;
    }
    n->ln[l].maxver = m;
}

static void fix_maxver_node(Node *n) {
    for (int l = 1; l < n->level; l++)
        fix_maxver_level(n, l);
}

static void insert_range_at(const uint8_t *b, const uint8_t *e, int64_t v,
                            Node **update) {
    Node *x = update[0];
    /* walk interior nodes once at level 0: covering value for e, presence
     * of an exact end node, and the free chain */
    int64_t end_cover = x->value;
    Node *it = x->ln[0].next;
    Node *interior = it;
    int have_end = 0;
    Node *stop = NULL; /* first node >= e */
    while (it && keycmp(it->key, e) < 0) {
        end_cover = it->value;
        it = it->ln[0].next;
    }
    stop = it;
    if (stop && keycmp(stop->key, e) == 0)
        have_end = 1;

    /* splice each level past the interior span in one step */
    for (int l = MAX_LEVEL - 1; l >= 0; l--) {
        Node *q = update[l]->ln[l].next;
        while (q && keycmp(q->key, e) < 0)
            q = q->ln[l].next;
        update[l]->ln[l].next = q;
    }
    /* free interior nodes (their next[0] chain is intact until freed) */
    while (interior && interior != stop) {
        Node *nx = interior->ln[0].next;
        node_free(interior);
        interior = nx;
    }

    /* insert begin node at v */
    int lv = rand_level();
    if (lv > cur_level) {
        for (int l = cur_level; l < lv; l++)
            update[l] = head;
        cur_level = lv;
    }
    Node *nb = node_new(b, lv, v);
    for (int l = 0; l < lv; l++) {
        nb->ln[l].next = update[l]->ln[l].next;
        update[l]->ln[l].next = nb;
    }
    /* insert end node restoring the covering value, unless present */
    Node *ne = NULL;
    if (!have_end) {
        int le = rand_level();
        if (le > cur_level) {
            for (int l = cur_level; l < le; l++)
                update[l] = head;
            cur_level = le;
        }
        ne = node_new(e, le, end_cover);
        for (int l = 0; l < le; l++) {
            Node *q = (l < lv) ? nb : update[l];
            ne->ln[l].next = q->ln[l].next;
            q->ln[l].next = ne;
        }
    }
    /* EXACT maxver maintenance (the annotations the query trusts at high
     * levels; approximations here skew conflict decisions — caught by the
     * oracle decision-parity test):
     *  - nb: every level's span contains the fresh [b,e)@v segment and
     *    v >= all stored versions, so maxver = v exactly (node_new did it).
     *  - ne: fresh node spanning beyond e — recompute every level from the
     *    level below (bottom-up; members' lower maxvers are final).
     *  - update[l], l >= lv: span absorbs [b,e)@v — max is exactly v.
     *  - update[l], l < lv: span SHRANK to [update[l], nb) — recompute. */
    if (ne)
        fix_maxver_node(ne);
    for (int l = 1; l < lv; l++)
        fix_maxver_level(update[l], l);
    for (int l = lv; l < cur_level; l++)
        update[l]->ln[l].maxver = v;
}


/* interleaved finger search for the merge (the reference finds 16 fingers
 * at once — SkipList::find :587-639 — then applies insertions right-to-left
 * so earlier fingers stay valid) */
static void find_fingers_batch(const uint8_t (*keys)[KEYB], int n,
                               Node **fingers /* n x MAX_LEVEL */) {
    typedef struct {
        const uint8_t *b;
        Node *x;
        int l, done;
        Node **out;
    } FQ;
    FQ q[IWAY];
    int nexti = 0, live = 0, nq = 0;
    for (int s = 0; s < IWAY && nexti < n; s++, nexti++) {
        q[s].b = keys[nexti];
        q[s].x = head;
        q[s].l = MAX_LEVEL - 1;
        q[s].done = 0;
        q[s].out = fingers + (size_t)nexti * MAX_LEVEL;
        live++;
    }
    nq = live;
    while (live > 0) {
        for (int s = 0; s < nq; s++) {
            FQ *c = &q[s];
            if (c->done)
                continue;
            Node *nx2 = c->x->ln[c->l].next;
            if (nx2 && keycmp(nx2->key, c->b) < 0) {
                c->x = nx2;
                __builtin_prefetch(nx2->ln[c->l].next);
            } else {
                c->out[c->l] = c->x;
                if (--c->l < 0) {
                    if (nexti < n) {
                        c->b = keys[nexti];
                        c->x = head;
                        c->l = MAX_LEVEL - 1;
                        c->out = fingers + (size_t)nexti * MAX_LEVEL;
                        nexti++;
                    } else {
                        c->done = 1;
                        live--;
                    }
                }
            }
        }
    }
}

/* incremental GC with a roving cursor (removeBefore :665 amortizes the
 * sweep the same way): scan `budget` nodes from where the last call left
 * off, merging below-floor nodes into their below-floor predecessor (the
 * clamp makes them the same segment). Level predecessors are tracked
 * during the level-0 walk so every unlink is O(level), not O(n). */
static uint8_t gc_key[KEYB];
static int gc_valid = 0;

static void remove_before(int64_t floor_v, int budget) {
    Node *pred[MAX_LEVEL];
    Node *x = head;
    for (int l = MAX_LEVEL - 1; l >= 0; l--) {
        if (gc_valid)
            while (x->ln[l].next && keycmp(x->ln[l].next->key, gc_key) < 0)
                x = x->ln[l].next;
        pred[l] = x;
    }
    Node *cur = x->ln[0].next;
    while (cur && budget-- > 0) {
        Node *nx = cur->ln[0].next;
        if (cur->value < floor_v && pred[0]->value < floor_v) {
            for (int l = 0; l < cur->level; l++) {
                /* the pred's span absorbs cur's adjacent span: the union's
                 * exact max is the max of the two stored maxes */
                if (cur->ln[l].maxver > pred[l]->ln[l].maxver)
                    pred[l]->ln[l].maxver = cur->ln[l].maxver;
                pred[l]->ln[l].next = cur->ln[l].next;
            }
            node_free(cur);
        } else {
            for (int l = 0; l < cur->level; l++)
                pred[l] = cur;
        }
        cur = nx;
    }
    if (cur) {
        memcpy(gc_key, cur->key, KEYB);
        gc_valid = 1;
    } else {
        gc_valid = 0; /* wrapped: next call restarts at head */
    }
}

/* ---------------- two-level bitmask (MiniConflictSet) ---------------- */

static uint64_t *bits, *sum; /* bit layer + 64x or-summary */
static int bit_words;

static void mcs_reset(int n) {
    bit_words = (n + 63) / 64;
    memset(bits, 0, bit_words * 8);
    memset(sum, 0, ((bit_words + 63) / 64) * 8);
}

static inline void mcs_set(int lo, int hi) { /* [lo, hi) */
    int wl = lo >> 6, wh = (hi - 1) >> 6;
    if (wl == wh) {
        bits[wl] |= ((~0ull) << (lo & 63)) &
                    ((~0ull) >> (63 - ((hi - 1) & 63)));
        sum[wl >> 6] |= 1ull << (wl & 63);
        return;
    }
    bits[wl] |= (~0ull) << (lo & 63);
    sum[wl >> 6] |= 1ull << (wl & 63);
    for (int w = wl + 1; w < wh; w++) {
        bits[w] = ~0ull;
        sum[w >> 6] |= 1ull << (w & 63);
    }
    bits[wh] |= (~0ull) >> (63 - ((hi - 1) & 63));
    sum[wh >> 6] |= 1ull << (wh & 63);
}

static inline int mcs_any(int lo, int hi) { /* any bit in [lo, hi)? */
    if (lo >= hi)
        return 0;
    int wl = lo >> 6, wh = (hi - 1) >> 6;
    if (wl == wh)
        return (bits[wl] & ((~0ull) << (lo & 63)) &
                ((~0ull) >> (63 - ((hi - 1) & 63)))) != 0;
    if (bits[wl] & ((~0ull) << (lo & 63)))
        return 1;
    if (bits[wh] & ((~0ull) >> (63 - ((hi - 1) & 63))))
        return 1;
    for (int sw = (wl + 1) >> 6; sw <= (wh - 1) >> 6; sw++) {
        uint64_t s = sum[sw];
        if (!s)
            continue;
        int base = sw << 6;
        int from = (sw == (wl + 1) >> 6) ? (wl + 1) - base : 0;
        int to = (sw == (wh - 1) >> 6) ? (wh - 1) - base : 63;
        for (int w = from; w <= to; w++)
            if ((s >> w) & 1)
                return 1;
    }
    return 0;
}

/* ---------------- batch processing ---------------- */

typedef struct {
    uint8_t key[KEYB];
    int32_t idx; /* endpoint id: txn*4 + {0=rb,1=re,2=wb,3=we} */
} Point;

static int point_cmp(const void *a, const void *b) {
    const Point *pa = a, *pb = b;
    int c = memcmp(pa->key, pb->key, KEYB);
    if (c)
        return c;
    return pa->idx - pb->idx;
}

/* sortPoints analogue (SkipList.cpp:227-279 radix-sorts the key stream):
 * for the setK key shape the distinguishing bytes are the 4-byte suffix, so
 * a stable 4-pass LSD radix on that u32 is the same total order as a full
 * byte-wise sort (stability keeps equal keys in input = idx order). */
static void radix_sort_points(Point *pts, Point *tmp, int n) {
    static uint32_t cnt[256];
    Point *src = pts, *dst = tmp;
    /* pass 0: endpoint kind — END (idx&1) before BEGIN at equal keys, the
     * reference's end<begin point ordering (getCharacter :147-177): without
     * it, touching ranges (wb_i == re_j) read as conflicting */
    {
        uint32_t c0 = 0, c1 = 0;
        for (int i = 0; i < n; i++)
            if (src[i].idx & 1)
                c0++;
        uint32_t p0 = 0, p1 = c0;
        (void)c1;
        for (int i = 0; i < n; i++)
            dst[(src[i].idx & 1) ? p0++ : p1++] = src[i];
        Point *t = src;
        src = dst;
        dst = t;
    }
    for (int pass = 0; pass < 4; pass++) {
        int shift = 8 * pass;
        memset(cnt, 0, sizeof(cnt));
        for (int i = 0; i < n; i++) {
            uint32_t v = ((uint32_t)src[i].key[12] << 24) |
                         ((uint32_t)src[i].key[13] << 16) |
                         ((uint32_t)src[i].key[14] << 8) |
                         (uint32_t)src[i].key[15];
            cnt[(v >> shift) & 0xFF]++;
        }
        uint32_t sum0 = 0;
        for (int d = 0; d < 256; d++) {
            uint32_t c = cnt[d];
            cnt[d] = sum0;
            sum0 += c;
        }
        for (int i = 0; i < n; i++) {
            uint32_t v = ((uint32_t)src[i].key[12] << 24) |
                         ((uint32_t)src[i].key[13] << 16) |
                         ((uint32_t)src[i].key[14] << 8) |
                         (uint32_t)src[i].key[15];
            dst[cnt[(v >> shift) & 0xFF]++] = src[i];
        }
        Point *t = src;
        src = dst;
        dst = t;
    }
    /* 5 stable passes total = odd number of swaps: result is in tmp */
    memcpy(pts, tmp, (size_t)n * sizeof(Point));
}

static void setk(uint8_t *dst, uint32_t key) {
    memset(dst, '.', 12);
    dst[12] = key >> 24;
    dst[13] = key >> 16;
    dst[14] = key >> 8;
    dst[15] = key;
}

/* --parity mode: decision cross-check against an independent oracle.
 * stdin:  "B T" then per batch a "snapshot now floor" line and T lines of
 *         "k1 s1 k2 s2" (read lo/span, write lo/span as setk ints).
 * stdout: per batch one line of T status digits, 0=conflict 2=committed —
 *         the same numbering as ops/batch.py, so the Python harness diffs
 *         the streams directly (the reference cross-checks its fast path
 *         against a naive oracle the same way, SkipList.cpp:1394). */
static int parity_main(void) {
    int B, T;
    if (scanf("%d %d", &B, &T) != 2)
        return 2;
    sl_init();
    Txn *txns = malloc((size_t)T * sizeof(Txn));
    Point *pts = malloc((size_t)T * 4 * sizeof(Point));
    Point *ptmp = malloc((size_t)T * 4 * sizeof(Point));
    int *pos = malloc((size_t)T * 4 * sizeof(int));
    uint8_t *conflict = malloc(T);
    bits = calloc(((size_t)T * 4 + 63) / 64 + 2, 8);
    sum = calloc((((size_t)T * 4 + 63) / 64 + 63) / 64 + 2, 8);
    Point *wsort = malloc((size_t)T * sizeof(Point));
    uint8_t(*cbs)[KEYB] = malloc((size_t)T * KEYB);
    uint8_t(*ces)[KEYB] = malloc((size_t)T * KEYB);
    Node **fingers = malloc((size_t)T * MAX_LEVEL * sizeof(Node *));
    char *out = malloc((size_t)T + 2);
    for (int i = 0; i < B; i++) {
        long long snapshot, now, floor_v;
        if (scanf("%lld %lld %lld", &snapshot, &now, &floor_v) != 3)
            return 2;
        for (int j = 0; j < T; j++) {
            uint32_t k1, s1, k2, s2;
            if (scanf("%u %u %u %u", &k1, &s1, &k2, &s2) != 4)
                return 2;
            setk(txns[j].rb, k1);
            setk(txns[j].re, k1 + s1);
            setk(txns[j].wb, k2);
            setk(txns[j].we, k2 + s2);
        }
        range_max_batch(txns, conflict, T, snapshot);
        for (int j = 0; j < T; j++) {
            memcpy(pts[4 * j + 0].key, txns[j].rb, KEYB);
            pts[4 * j + 0].idx = 4 * j + 0;
            memcpy(pts[4 * j + 1].key, txns[j].re, KEYB);
            pts[4 * j + 1].idx = 4 * j + 1;
            memcpy(pts[4 * j + 2].key, txns[j].wb, KEYB);
            pts[4 * j + 2].idx = 4 * j + 2;
            memcpy(pts[4 * j + 3].key, txns[j].we, KEYB);
            pts[4 * j + 3].idx = 4 * j + 3;
        }
        radix_sort_points(pts, ptmp, T * 4);
        for (int p = 0; p < T * 4; p++)
            pos[pts[p].idx] = p;
        mcs_reset(T * 4);
        for (int j = 0; j < T; j++) {
            if (conflict[j])
                continue;
            if (mcs_any(pos[4 * j + 0], pos[4 * j + 1]))
                conflict[j] = 1;
            else
                mcs_set(pos[4 * j + 2], pos[4 * j + 3]);
        }
        int nw = 0;
        for (int j = 0; j < T; j++)
            if (!conflict[j]) {
                memcpy(wsort[nw].key, txns[j].wb, KEYB);
                wsort[nw].idx = j;
                nw++;
            }
        qsort(wsort, nw, sizeof(Point), point_cmp);
        int nc = 0;
        for (int w = 0; w < nw; w++) {
            const Txn *tx = &txns[wsort[w].idx];
            if (nc && memcmp(tx->wb, ces[nc - 1], KEYB) <= 0) {
                if (memcmp(tx->we, ces[nc - 1], KEYB) > 0)
                    memcpy(ces[nc - 1], tx->we, KEYB);
            } else {
                memcpy(cbs[nc], tx->wb, KEYB);
                memcpy(ces[nc], tx->we, KEYB);
                nc++;
            }
        }
        find_fingers_batch(cbs, nc, fingers);
        for (int w = nc - 1; w >= 0; w--)
            insert_range_at(cbs[w], ces[w], now,
                            fingers + (size_t)w * MAX_LEVEL);
        remove_before(floor_v, 3 * nw + 10);
        for (int j = 0; j < T; j++)
            out[j] = conflict[j] ? '0' : '2';
        out[T] = '\n';
        out[T + 1] = 0;
        fputs(out, stdout);
    }
    fflush(stdout);
    return 0;
}

int main(int argc, char **argv) {
    if (argc > 1 && strcmp(argv[1], "--parity") == 0)
        return parity_main();
    int T = argc > 1 ? atoi(argv[1]) : 2500; /* txns per batch */
    int B = argc > 2 ? atoi(argv[2]) : 500;  /* batches */
    sl_init();

    Txn *txns = malloc((size_t)T * sizeof(Txn));
    Point *pts = malloc((size_t)T * 4 * sizeof(Point));
    Point *ptmp = malloc((size_t)T * 4 * sizeof(Point));
    int *pos = malloc((size_t)T * 4 * sizeof(int));
    uint8_t *conflict = malloc(T);
    bits = calloc(((size_t)T * 4 + 63) / 64 + 2, 8);
    sum = calloc((((size_t)T * 4 + 63) / 64 + 63) / 64 + 2, 8);
    /* merge buffer: surviving writes sorted -> union */
    Point *wsort = malloc((size_t)T * sizeof(Point));
    uint8_t (*cbs)[KEYB] = malloc((size_t)T * KEYB);
    uint8_t (*ces)[KEYB] = malloc((size_t)T * KEYB);
    Node **fingers = malloc((size_t)T * MAX_LEVEL * sizeof(Node *));

    /* pre-generate all batches' data (skipListTest generates test data
     * before the timed loop; we re-derive per batch from the PRNG inside
     * the timed loop — generation is ~ns/txn, negligible vs detection) */
    long long total_txns = 0, total_committed = 0;
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);

    for (int i = 0; i < B; i++) {
        for (int j = 0; j < T; j++) {
            uint32_t k1 = rnd(20000000), s1 = 1 + rnd(10);
            uint32_t k2 = rnd(20000000), s2 = 1 + rnd(10);
            setk(txns[j].rb, k1);
            setk(txns[j].re, k1 + s1);
            setk(txns[j].wb, k2);
            setk(txns[j].we, k2 + s2);
        }
        /* history depth ~125k txns regardless of batch size (the
         * reference's 50 x 2500; detect at i+WB with floor i) */
        int WB = (125000 + T - 1) / T;
        int64_t snapshot = i, now = i + WB, floor_v = i;

        /* 1. history check: read range max over committed writes */
        range_max_batch(txns, conflict, T, snapshot);

        /* 2. intra-batch: sort endpoints, bitmask in batch order */
        for (int j = 0; j < T; j++) {
            memcpy(pts[4 * j + 0].key, txns[j].rb, KEYB);
            pts[4 * j + 0].idx = 4 * j + 0;
            memcpy(pts[4 * j + 1].key, txns[j].re, KEYB);
            pts[4 * j + 1].idx = 4 * j + 1;
            memcpy(pts[4 * j + 2].key, txns[j].wb, KEYB);
            pts[4 * j + 2].idx = 4 * j + 2;
            memcpy(pts[4 * j + 3].key, txns[j].we, KEYB);
            pts[4 * j + 3].idx = 4 * j + 3;
        }
        radix_sort_points(pts, ptmp, T * 4);
        for (int p = 0; p < T * 4; p++)
            pos[pts[p].idx] = p;
        mcs_reset(T * 4);
        for (int j = 0; j < T; j++) {
            if (conflict[j])
                continue;
            if (mcs_any(pos[4 * j + 0], pos[4 * j + 1]))
                conflict[j] = 1;
            else
                mcs_set(pos[4 * j + 2], pos[4 * j + 3]);
        }

        /* 3. merge surviving writes at `now`: sort, union, insert */
        int nw = 0;
        for (int j = 0; j < T; j++)
            if (!conflict[j]) {
                memcpy(wsort[nw].key, txns[j].wb, KEYB);
                wsort[nw].idx = j;
                nw++;
                total_committed++;
            }
        /* sort surviving writes by begin key; coalesce overlapping/adjacent
         * into disjoint ranges (combineWriteConflictRanges :1320) */
        qsort(wsort, nw, sizeof(Point), point_cmp);
        int nc = 0;
        for (int w = 0; w < nw; w++) {
            const Txn *tx = &txns[wsort[w].idx];
            if (nc && memcmp(tx->wb, ces[nc - 1], KEYB) <= 0) {
                if (memcmp(tx->we, ces[nc - 1], KEYB) > 0)
                    memcpy(ces[nc - 1], tx->we, KEYB);
            } else {
                memcpy(cbs[nc], tx->wb, KEYB);
                memcpy(ces[nc], tx->we, KEYB);
                nc++;
            }
        }
        /* striped merge: all fingers first (interleaved), then apply
         * right-to-left so earlier fingers stay valid */
        find_fingers_batch(cbs, nc, fingers);
        for (int w = nc - 1; w >= 0; w--)
            insert_range_at(cbs[w], ces[w], now,
                            fingers + (size_t)w * MAX_LEVEL);

        /* 4. window GC, amortized like removeBefore */
        remove_before(floor_v, 3 * nw + 10);

        total_txns += T;
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double el = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    printf("{\"txns_per_batch\": %d, \"batches\": %d, \"elapsed_s\": %.3f, "
           "\"txns_per_sec\": %.0f, \"committed_frac\": %.4f}\n",
           T, B, el, total_txns / el,
           (double)total_committed / (double)total_txns);
    return 0;
}
