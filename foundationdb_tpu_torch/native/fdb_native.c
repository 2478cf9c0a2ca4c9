/* Native host hot paths of the PyTorch/CUDA port (foundationdb_tpu_torch).
 *
 * The port's copy of the JAX package's C extension
 * (foundationdb_tpu/native/fdb_native.c), line for line but for the two
 * differences below. The reference implements its hot host-side loops in
 * C++ (the conflict engine's key juggling in fdbserver/SkipList.cpp, CRC32c
 * in fdbrpc/crc32c.cpp, serialization in flow/serialize.h). The card
 * replaces the conflict algorithms, but feeding it still requires encoding
 * arbitrary-length byte keys into fixed-width limb arrays at millions of
 * keys/sec — far beyond what per-key Python can do. This module provides:
 *
 *   encode_keys_into(keys, out_buffer, round_up[, key_bytes])
 *       bulk key -> limb encoding (layout matches utils/keys.py: KEY_BYTES
 *       prefix as big-endian u32 limbs + one length limb, SoA (L, N))
 *   encode_conflict_ranges(...)
 *       a whole conflict chunk in one pass (below)
 *   crc32c(data, init) -> int
 *       CRC-32C (Castagnoli), the checksum the reference uses for packets
 *       and disk pages (fdbrpc/crc32c.cpp) — software slice-by-8 here.
 *   the wire codec, IndexedSet, VStore, the redwood block codec, blooms and
 *   run handles, and the transport's server and client planes.
 *
 * Differences from the JAX package's file:
 *
 *   1. encode_conflict_ranges writes the port's packed batch (the views
 *      that ops/step_graph.py batch_layout / batch_views give) in its one
 *      pass: key limbs signed, with the sign bit flipped (utils/keys.py
 *      to_signed_limbs); unused key columns PAD_LIMB; unused owners T in
 *      the pooled layout, each slot's fixed txn (slot / stride) in the
 *      strided one, where range i of txn t lands at slot t * stride + i;
 *      snapshot 0 and txn_valid 0 for every txn it does not fill. The
 *      buffer equals, byte for byte, the one the numpy encoder writes
 *      (ops/conflict.py BatchEncoder). The flip is done here, in the store
 *      of each limb, rather than by the caller afterwards: a second pass
 *      over the pinned slot would cost what the one pass saves.
 *   2. The module is the port's own: nothing of the JAX package is
 *      included or called. It keeps PyInit_fdb_native; the loader
 *      (native/__init__.py) builds it under its own file name and never
 *      puts it in sys.modules, so both packages' extensions load side by
 *      side in one process, each with its own static state (the wire
 *      registry among it).
 *
 * Built as a plain CPython extension (no pybind11/numpy headers; buffers via
 * the buffer protocol) so it compiles anywhere with a C compiler. The GIL
 * discipline is the JAX package's: a pass lets other threads run only
 * where it touches no Python object (large CRC buffers, the planes' byte
 * loops); the encoder holds the GIL throughout.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#define KEY_BYTES 24
#define NUM_LIMBS (KEY_BYTES / 4 + 1)

/* ------------------------------------------------------------------ */
/* CRC-32C, slice-by-8                                                 */
/* ------------------------------------------------------------------ */

static uint32_t crc32c_table[8][256];
static int crc32c_ready = 0;

static void crc32c_init(void) {
    uint32_t poly = 0x82F63B78u; /* reversed Castagnoli */
    for (int i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
        crc32c_table[0][i] = c;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = crc32c_table[0][i];
        for (int t = 1; t < 8; t++) {
            c = crc32c_table[0][c & 0xFF] ^ (c >> 8);
            crc32c_table[t][i] = c;
        }
    }
    crc32c_ready = 1;
}

static uint32_t crc32c_sw(uint32_t crc, const uint8_t *buf, Py_ssize_t len) {
    crc = ~crc;
    while (len >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, buf, 4);
        memcpy(&hi, buf + 4, 4);
        lo ^= crc;
        crc = crc32c_table[7][lo & 0xFF] ^
              crc32c_table[6][(lo >> 8) & 0xFF] ^
              crc32c_table[5][(lo >> 16) & 0xFF] ^
              crc32c_table[4][lo >> 24] ^
              crc32c_table[3][hi & 0xFF] ^
              crc32c_table[2][(hi >> 8) & 0xFF] ^
              crc32c_table[1][(hi >> 16) & 0xFF] ^
              crc32c_table[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len-- > 0)
        crc = crc32c_table[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

static PyObject *py_crc32c(PyObject *self, PyObject *args) {
    Py_buffer data;
    unsigned int init = 0;
    if (!PyArg_ParseTuple(args, "y*|I", &data, &init))
        return NULL;
    uint32_t crc;
    if (data.len >= (Py_ssize_t)(64 * 1024)) {
        /* transport checksums whole frames; beyond the save/restore cost
         * crossover, let other threads run for the duration of the pass */
        Py_BEGIN_ALLOW_THREADS
        crc = crc32c_sw(init, (const uint8_t *)data.buf, data.len);
        Py_END_ALLOW_THREADS
    } else {
        crc = crc32c_sw(init, (const uint8_t *)data.buf, data.len);
    }
    PyBuffer_Release(&data);
    return PyLong_FromUnsignedLong(crc);
}

/* ------------------------------------------------------------------ */
/* Redwood block codec                                                 */
/* ------------------------------------------------------------------ */

/* On-disk structs of the redwood storage engine (storage/redwood.py is the
 * binding authority; the PROTO005-style parity test in tests/test_redwood.py
 * cross-checks these comments against the Python field lists):
 *
 *   RedwoodBlockHeader { magic: u32, n_entries: u32, payload_bytes: u32, crc: u32 }
 *   RedwoodBlockEntry { shared: u16, suffix_len: u16, value_len: u32 }
 *   RedwoodRunHeader { magic: u32, format_version: u32, run_id: u64, meta_seq: u64, level: u32, n_blocks: u32, n_sources: u32, index_bytes: u32, aux_bytes: u32, bloom_bytes: u32, body_crc: u32 }
 *   RedwoodRunIndexEntry { offset: u32, length: u32, last_key_len: u16 }
 *   RedwoodBloomHeader { magic: u32, n_hashes: u32, n_bits: u64, n_keys: u64 }
 *
 * All fields little-endian. The block payload is a sequence of entries,
 * each RedwoodBlockEntry header + key suffix + value, keys prefix-
 * compressed against the previous key in the block; crc is CRC-32C over
 * the payload. A run body is sources + index + aux + bloom + blocks; the
 * bloom section is a RedwoodBloomHeader followed by ceil(n_bits/8) filter
 * bytes (double hashing over CRC-32C, see rw_bloom_hashes below). The
 * block codec AND the point-read path live in C (RedwoodRun handles further
 * down); run-file assembly stays in Python on both paths, so there is
 * exactly one orchestration to keep correct. The Python fallbacks
 * (storage/redwood.py py_encode_block/py_decode_block/py_bloom_build/
 * py_bloom_query) must produce bit-identical bytes and decisions — the
 * parity fuzzes in tests/test_redwood.py and tests/test_redwood_native.py
 * are the gate. */

#define REDWOOD_BLOCK_MAGIC 0x5EDB10C5u

static PyObject *py_redwood_encode_block(PyObject *self, PyObject *arg) {
    PyObject *seq = PySequence_Fast(arg, "expected a sequence of (k, v)");
    if (!seq)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    /* pass 1: size + validation */
    Py_ssize_t payload = 0;
    const char *prev = NULL;
    Py_ssize_t prev_len = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        char *k, *v;
        Py_ssize_t klen, vlen;
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2 ||
            PyBytes_AsStringAndSize(PyTuple_GET_ITEM(item, 0), &k, &klen) < 0 ||
            PyBytes_AsStringAndSize(PyTuple_GET_ITEM(item, 1), &v, &vlen) < 0) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_TypeError, "expected (bytes, bytes)");
            Py_DECREF(seq);
            return NULL;
        }
        if (klen > 0xFFFF || vlen > 0xFFFFFFFFLL) {
            PyErr_SetString(PyExc_ValueError, "redwood entry too large");
            Py_DECREF(seq);
            return NULL;
        }
        Py_ssize_t cap = prev_len < klen ? prev_len : klen;
        if (cap > 0xFFFF)
            cap = 0xFFFF;
        Py_ssize_t shared = 0;
        while (shared < cap && prev[shared] == k[shared])
            shared++;
        payload += 8 + (klen - shared) + vlen;
        prev = k;
        prev_len = klen;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, 16 + payload);
    if (!out) {
        Py_DECREF(seq);
        return NULL;
    }
    uint8_t *o = (uint8_t *)PyBytes_AS_STRING(out);
    uint8_t *p = o + 16;
    prev = NULL;
    prev_len = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        char *k = PyBytes_AS_STRING(PyTuple_GET_ITEM(item, 0));
        char *v = PyBytes_AS_STRING(PyTuple_GET_ITEM(item, 1));
        Py_ssize_t klen = PyBytes_GET_SIZE(PyTuple_GET_ITEM(item, 0));
        Py_ssize_t vlen = PyBytes_GET_SIZE(PyTuple_GET_ITEM(item, 1));
        Py_ssize_t cap = prev_len < klen ? prev_len : klen;
        if (cap > 0xFFFF)
            cap = 0xFFFF;
        Py_ssize_t shared = 0;
        while (shared < cap && prev[shared] == k[shared])
            shared++;
        uint16_t sh16 = (uint16_t)shared, sl16 = (uint16_t)(klen - shared);
        uint32_t vl32 = (uint32_t)vlen;
        memcpy(p, &sh16, 2);
        memcpy(p + 2, &sl16, 2);
        memcpy(p + 4, &vl32, 4);
        p += 8;
        memcpy(p, k + shared, klen - shared);
        p += klen - shared;
        memcpy(p, v, vlen);
        p += vlen;
        prev = k;
        prev_len = klen;
    }
    uint32_t magic = REDWOOD_BLOCK_MAGIC, n32 = (uint32_t)n,
             pl32 = (uint32_t)payload;
    uint32_t crc = crc32c_sw(0, o + 16, payload);
    memcpy(o, &magic, 4);
    memcpy(o + 4, &n32, 4);
    memcpy(o + 8, &pl32, 4);
    memcpy(o + 12, &crc, 4);
    Py_DECREF(seq);
    return out;
}

static PyObject *py_redwood_decode_block(PyObject *self, PyObject *arg) {
    Py_buffer data;
    if (PyObject_GetBuffer(arg, &data, PyBUF_SIMPLE) < 0)
        return NULL;
    const uint8_t *b = (const uint8_t *)data.buf;
    if (data.len < 16)
        goto corrupt;
    uint32_t magic, n, plen, crc;
    memcpy(&magic, b, 4);
    memcpy(&n, b + 4, 4);
    memcpy(&plen, b + 8, 4);
    memcpy(&crc, b + 12, 4);
    if (magic != REDWOOD_BLOCK_MAGIC || (Py_ssize_t)plen != data.len - 16 ||
        crc32c_sw(0, b + 16, plen) != crc)
        goto corrupt;
    /* every entry costs at least its 8-byte header: reject a corrupt count
     * before it sizes the output list */
    if (n > plen / 8)
        goto corrupt;
    {
        PyObject *out = PyList_New(n);
        if (!out) {
            PyBuffer_Release(&data);
            return NULL;
        }
        const uint8_t *p = b + 16, *end = b + 16 + plen;
        PyObject *prev_key = NULL;
        for (uint32_t i = 0; i < n; i++) {
            if (end - p < 8)
                goto corrupt_list;
            uint16_t shared, slen;
            uint32_t vlen;
            memcpy(&shared, p, 2);
            memcpy(&slen, p + 2, 2);
            memcpy(&vlen, p + 4, 4);
            p += 8;
            if ((Py_ssize_t)(end - p) < (Py_ssize_t)slen + (Py_ssize_t)vlen ||
                (prev_key == NULL && shared != 0) ||
                (prev_key != NULL && shared > PyBytes_GET_SIZE(prev_key)))
                goto corrupt_list;
            PyObject *key = PyBytes_FromStringAndSize(NULL, shared + slen);
            if (!key)
                goto err_list;
            if (shared)
                memcpy(PyBytes_AS_STRING(key), PyBytes_AS_STRING(prev_key),
                       shared);
            memcpy(PyBytes_AS_STRING(key) + shared, p, slen);
            p += slen;
            PyObject *val = PyBytes_FromStringAndSize((const char *)p, vlen);
            p += vlen;
            PyObject *pair = val ? PyTuple_Pack(2, key, val) : NULL;
            Py_XDECREF(val);
            if (!pair) {
                Py_DECREF(key);
                goto err_list;
            }
            PyList_SET_ITEM(out, i, pair);
            Py_XDECREF(prev_key);
            prev_key = key; /* transfer our ref; pair holds its own */
        }
        Py_XDECREF(prev_key);
        if (p != end)
            goto corrupt_obj;
        PyBuffer_Release(&data);
        return out;
    corrupt_list:
        Py_XDECREF(prev_key);
        Py_DECREF(out);
        goto corrupt;
    err_list:
        Py_XDECREF(prev_key);
        Py_DECREF(out);
        PyBuffer_Release(&data);
        return NULL;
    corrupt_obj:
        Py_DECREF(out);
        goto corrupt;
    }
corrupt:
    PyBuffer_Release(&data);
    PyErr_SetString(PyExc_ValueError, "corrupt redwood block");
    return NULL;
}

/* ------------------------------------------------------------------ */
/* Bulk key encoding                                                   */
/* ------------------------------------------------------------------ */

/* Encode one key into column `col` of a limb-major uint32 buffer with
 * `cap` columns. Mirrors utils/keys.py encode_key exactly — the single
 * copy of the round-up length rule both bulk paths share (a divergence
 * between them would make the device and the host encode the same key
 * differently). */
static int encode_key_col(PyObject *keyobj, uint32_t *o, Py_ssize_t cap,
                          int num_limbs, int key_bytes, int round_up,
                          Py_ssize_t col) {
    char *kbuf;
    Py_ssize_t klen;
    if (PyBytes_AsStringAndSize(keyobj, &kbuf, &klen) < 0)
        return -1;
    uint8_t padded[64];
    Py_ssize_t use = klen < key_bytes ? klen : key_bytes;
    memcpy(padded, kbuf, use);
    memset(padded + use, 0, key_bytes - use);
    for (int l = 0; l < num_limbs - 1; l++) {
        const uint8_t *p = padded + 4 * l;
        o[(Py_ssize_t)l * cap + col] =
            ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
            ((uint32_t)p[2] << 8) | (uint32_t)p[3];
    }
    uint32_t lenlimb;
    if (klen > key_bytes)
        lenlimb = round_up ? ((uint32_t)key_bytes + 1) : (uint32_t)key_bytes;
    else
        lenlimb = (uint32_t)klen;
    o[(Py_ssize_t)(num_limbs - 1) * cap + col] = lenlimb;
    return 0;
}

static int check_key_bytes(int key_bytes) {
    if (key_bytes <= 0 || key_bytes > 64 || key_bytes % 4 != 0) {
        PyErr_SetString(PyExc_ValueError, "key_bytes must be in 4..64, /4");
        return -1;
    }
    return 0;
}

/* encode_keys_into(keys: sequence of bytes, out: writable buffer of
 * uint32[NUM_LIMBS * n] in SoA layout (limb-major), round_up: bool)
 * Mirrors utils/keys.py encode_key exactly. */
static PyObject *py_encode_keys_into(PyObject *self, PyObject *args) {
    PyObject *keys;
    Py_buffer out;
    int round_up = 0;
    int key_bytes = KEY_BYTES;
    if (!PyArg_ParseTuple(args, "Ow*|pi", &keys, &out, &round_up, &key_bytes))
        return NULL;
    if (check_key_bytes(key_bytes) < 0) {
        PyBuffer_Release(&out);
        return NULL;
    }
    int num_limbs = key_bytes / 4 + 1;

    PyObject *seq = PySequence_Fast(keys, "keys must be a sequence");
    if (!seq) {
        PyBuffer_Release(&out);
        return NULL;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if ((Py_ssize_t)(out.len) < (Py_ssize_t)(num_limbs * n * 4)) {
        PyBuffer_Release(&out);
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError, "output buffer too small");
        return NULL;
    }
    uint32_t *o = (uint32_t *)out.buf;

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        if (encode_key_col(item, o, n, num_limbs, key_bytes, round_up, i) < 0) {
            PyBuffer_Release(&out);
            Py_DECREF(seq);
            return NULL;
        }
    }
    PyBuffer_Release(&out);
    Py_DECREF(seq);
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* Wire codec (utils/wire.py format; flow/serialize.h analogue)        */
/*                                                                     */
/* Fast path only: exact builtin types plus REGISTERED enum/dataclass  */
/* types. Anything else raises, and the Python wrapper re-runs the     */
/* pure-Python codec, which remains the semantic authority for every   */
/* edge case (int >64-bit, bytearray, subclasses, schema skew).        */
/* ------------------------------------------------------------------ */

#define W_MAGIC 0xF5
#define W_VERSION 1
#define W_MAX_DEPTH 64
#define W_MAX_CONTAINER (1 << 24)

/* Contention-management wire structs this codec round-trips through the
 * generic registered-dataclass path (no dedicated emitter yet). Kept as
 * schema comments so protolint's PROTO005 parity gate pins the field
 * lists against the Python dataclasses:
 *   HotRange { begin: key, end: key, rate: float }
 *   HotRangesReply { ranges: [HotRange], total_rate: float }
 *   ThrottleEntry { begin: key, end: key, release_tps: float, backoff: float }
 *   RateInfoReply { tps: float, throttles: [ThrottleEntry] }
 */

/* registry: by_id[int] = (cls, names_tuple_or_None); by_type[type] = id */
static PyObject *g_by_id = NULL;
static PyObject *g_by_type = NULL;

static PyObject *py_wire_set_registry(PyObject *self, PyObject *args) {
    PyObject *by_id, *by_type;
    if (!PyArg_ParseTuple(args, "OO", &by_id, &by_type))
        return NULL;
    Py_XDECREF(g_by_id);
    Py_XDECREF(g_by_type);
    g_by_id = Py_NewRef(by_id);
    g_by_type = Py_NewRef(by_type);
    Py_RETURN_NONE;
}

typedef struct {
    uint8_t *buf;
    Py_ssize_t len, cap;
} WBuf;

static int wb_grow(WBuf *w, Py_ssize_t extra) {
    Py_ssize_t need = w->len + extra;
    if (need <= w->cap)
        return 0;
    Py_ssize_t cap = w->cap * 2;
    if (cap < need)
        cap = need + 256;
    uint8_t *nb = PyMem_Realloc(w->buf, cap);
    if (!nb) {
        PyErr_NoMemory();
        return -1;
    }
    w->buf = nb;
    w->cap = cap;
    return 0;
}

static inline int wb_byte(WBuf *w, uint8_t b) {
    if (w->len >= w->cap && wb_grow(w, 1) < 0)
        return -1;
    w->buf[w->len++] = b;
    return 0;
}

static inline int wb_raw(WBuf *w, const void *p, Py_ssize_t n) {
    if (n == 0)
        return 0; /* an empty source may be NULL (fresh WBuf): UB to memcpy */
    if (w->len + n > w->cap && wb_grow(w, n) < 0)
        return -1;
    memcpy(w->buf + w->len, p, n);
    w->len += n;
    return 0;
}

static inline int wb_varint(WBuf *w, uint64_t v) {
    while (v > 0x7F) {
        if (wb_byte(w, (uint8_t)(v & 0x7F) | 0x80) < 0)
            return -1;
        v >>= 7;
    }
    return wb_byte(w, (uint8_t)v);
}

static int enc_value(WBuf *w, PyObject *obj, int depth);

static int enc_container_items(WBuf *w, PyObject *seq, int depth) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject **items = PySequence_Fast_ITEMS(seq);
    for (Py_ssize_t i = 0; i < n; i++)
        if (enc_value(w, items[i], depth) < 0)
            return -1;
    return 0;
}

static int enc_value(WBuf *w, PyObject *obj, int depth) {
    if (depth > W_MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "nesting too deep");
        return -1;
    }
    PyTypeObject *tp = Py_TYPE(obj);
    if (tp == &PyBytes_Type) {
        Py_ssize_t n = PyBytes_GET_SIZE(obj);
        if (wb_byte(w, 'b') < 0 || wb_varint(w, (uint64_t)n) < 0)
            return -1;
        return wb_raw(w, PyBytes_AS_STRING(obj), n);
    }
    if (tp == &PyLong_Type) {
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
        if (overflow || (v == -1 && PyErr_Occurred())) {
            PyErr_SetString(PyExc_OverflowError, "int beyond int64");
            return -1; /* wrapper falls back to the Python codec */
        }
        uint64_t u = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
        if (wb_byte(w, 'i') < 0)
            return -1;
        return wb_varint(w, u);
    }
    if (tp == &PyUnicode_Type) {
        Py_ssize_t n;
        const char *s = PyUnicode_AsUTF8AndSize(obj, &n);
        if (!s)
            return -1;
        if (wb_byte(w, 's') < 0 || wb_varint(w, (uint64_t)n) < 0)
            return -1;
        return wb_raw(w, s, n);
    }
    if (tp == &PyList_Type) {
        if (wb_byte(w, 'l') < 0 ||
            wb_varint(w, (uint64_t)PyList_GET_SIZE(obj)) < 0)
            return -1;
        return enc_container_items(w, obj, depth + 1);
    }
    if (tp == &PyTuple_Type) {
        if (wb_byte(w, 't') < 0 ||
            wb_varint(w, (uint64_t)PyTuple_GET_SIZE(obj)) < 0)
            return -1;
        return enc_container_items(w, obj, depth + 1);
    }
    if (tp == &PyDict_Type) {
        if (wb_byte(w, 'm') < 0 ||
            wb_varint(w, (uint64_t)PyDict_GET_SIZE(obj)) < 0)
            return -1;
        Py_ssize_t pos = 0;
        PyObject *k, *v;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            if (enc_value(w, k, depth + 1) < 0 ||
                enc_value(w, v, depth + 1) < 0)
                return -1;
        }
        return 0;
    }
    if (obj == Py_None)
        return wb_byte(w, 'N');
    if (obj == Py_True)
        return wb_byte(w, 'T');
    if (obj == Py_False)
        return wb_byte(w, 'F');
    if (tp == &PyFloat_Type) {
        double d = PyFloat_AS_DOUBLE(obj);
        uint64_t bits;
        memcpy(&bits, &d, 8);
        uint8_t be[8];
        for (int i = 0; i < 8; i++)
            be[i] = (uint8_t)(bits >> (56 - 8 * i));
        if (wb_byte(w, 'd') < 0)
            return -1;
        return wb_raw(w, be, 8);
    }
    if (tp == &PySet_Type || tp == &PyFrozenSet_Type) {
        if (wb_byte(w, 'S') < 0 ||
            wb_varint(w, (uint64_t)PySet_GET_SIZE(obj)) < 0)
            return -1;
        PyObject *it = PyObject_GetIter(obj);
        if (!it)
            return -1;
        PyObject *item;
        while ((item = PyIter_Next(it)) != NULL) {
            int rc = enc_value(w, item, depth + 1);
            Py_DECREF(item);
            if (rc < 0) {
                Py_DECREF(it);
                return -1;
            }
        }
        Py_DECREF(it);
        return PyErr_Occurred() ? -1 : 0;
    }
    /* registered enum / dataclass (exact type match only) */
    PyObject *idobj =
        g_by_type ? PyDict_GetItem(g_by_type, (PyObject *)tp) : NULL;
    if (idobj) {
        uint64_t tid = (uint64_t)PyLong_AsUnsignedLongLong(idobj);
        if (tid == (uint64_t)-1 && PyErr_Occurred())
            return -1; /* registry id not an int-like: report, don't emit */
        if (PyLong_Check(obj)) { /* IntEnum */
            long long v = PyLong_AsLongLong(obj);
            if (v == -1 && PyErr_Occurred())
                return -1;
            uint64_t u = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
            if (wb_byte(w, 'E') < 0 || wb_varint(w, tid) < 0)
                return -1;
            return wb_varint(w, u);
        }
        PyObject *entry = PyDict_GetItem(g_by_id, idobj);
        if (!entry || !PyTuple_Check(entry) || PyTuple_GET_SIZE(entry) < 2) {
            PyErr_SetString(PyExc_ValueError, "bad registry entry");
            return -1;
        }
        PyObject *names = PyTuple_GET_ITEM(entry, 1);
        if (names == Py_None) {
            PyErr_SetString(PyExc_ValueError, "non-dataclass struct");
            return -1;
        }
        Py_ssize_t nf = PyTuple_GET_SIZE(names);
        if (wb_byte(w, 'R') < 0 || wb_varint(w, tid) < 0 ||
            wb_varint(w, (uint64_t)nf) < 0)
            return -1;
        for (Py_ssize_t i = 0; i < nf; i++) {
            PyObject *v = PyObject_GetAttr(obj, PyTuple_GET_ITEM(names, i));
            if (!v)
                return -1;
            int rc = enc_value(w, v, depth + 1);
            Py_DECREF(v);
            if (rc < 0)
                return -1;
        }
        return 0;
    }
    PyErr_Format(PyExc_OverflowError, "no native fast path for %s",
                 tp->tp_name); /* wrapper falls back */
    return -1;
}

static PyObject *py_wire_dumps(PyObject *self, PyObject *obj) {
    WBuf w = {NULL, 0, 0};
    if (wb_grow(&w, 64) < 0)
        return NULL;
    w.buf[w.len++] = W_MAGIC;
    w.buf[w.len++] = W_VERSION;
    if (enc_value(&w, obj, 0) < 0) {
        PyMem_Free(w.buf);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)w.buf, w.len);
    PyMem_Free(w.buf);
    return out;
}

/* ---------------- decode ---------------- */

typedef struct {
    const uint8_t *p, *end;
} RBuf;

static int rb_varint(RBuf *r, uint64_t *out) {
    uint64_t v = 0;
    int shift = 0;
    for (;;) {
        if (r->p >= r->end) {
            PyErr_SetString(PyExc_ValueError, "truncated");
            return -1;
        }
        uint8_t b = *r->p++;
        if (shift > 63 || (shift == 63 && (b & 0x7E))) {
            /* >64-bit varint: legit via the Python encoder (big ints);
             * every such frame must fall back to the Python decoder —
             * shifting past the word would be UB and silent corruption */
            PyErr_SetString(PyExc_OverflowError, "varint beyond int64");
            return -1;
        }
        v |= ((uint64_t)(b & 0x7F)) << shift;
        if (!(b & 0x80)) {
            *out = v;
            return 0;
        }
        shift += 7;
    }
}

static PyObject *dec_value(RBuf *r, int depth) {
    if (depth > W_MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "nesting too deep");
        return NULL;
    }
    if (r->p >= r->end) {
        PyErr_SetString(PyExc_ValueError, "truncated");
        return NULL;
    }
    uint8_t tag = *r->p++;
    switch (tag) {
    case 'i': {
        uint64_t u;
        if (rb_varint(r, &u) < 0)
            return NULL;
        long long v = (long long)((u >> 1) ^ (~(u & 1) + 1));
        return PyLong_FromLongLong(v);
    }
    case 'b': {
        uint64_t n;
        if (rb_varint(r, &n) < 0)
            return NULL;
        if ((uint64_t)(r->end - r->p) < n) {
            PyErr_SetString(PyExc_ValueError, "truncated");
            return NULL;
        }
        PyObject *o = PyBytes_FromStringAndSize((const char *)r->p, n);
        r->p += n;
        return o;
    }
    case 'N':
        Py_RETURN_NONE;
    case 'T':
        Py_RETURN_TRUE;
    case 'F':
        Py_RETURN_FALSE;
    case 'd': {
        if (r->end - r->p < 8) {
            PyErr_SetString(PyExc_ValueError, "truncated");
            return NULL;
        }
        uint64_t bits = 0;
        for (int i = 0; i < 8; i++)
            bits = (bits << 8) | r->p[i];
        r->p += 8;
        double d;
        memcpy(&d, &bits, 8);
        return PyFloat_FromDouble(d);
    }
    case 's': {
        uint64_t n;
        if (rb_varint(r, &n) < 0)
            return NULL;
        if ((uint64_t)(r->end - r->p) < n) {
            PyErr_SetString(PyExc_ValueError, "truncated");
            return NULL;
        }
        PyObject *o = PyUnicode_DecodeUTF8((const char *)r->p, n, NULL);
        r->p += n;
        return o;
    }
    case 'l':
    case 't':
    case 'S': {
        uint64_t n;
        if (rb_varint(r, &n) < 0)
            return NULL;
        if (n > W_MAX_CONTAINER) {
            PyErr_SetString(PyExc_ValueError, "container too large");
            return NULL;
        }
        PyObject *lst = (tag == 't') ? PyTuple_New(n) : PyList_New(n);
        if (!lst)
            return NULL;
        for (uint64_t i = 0; i < n; i++) {
            PyObject *v = dec_value(r, depth + 1);
            if (!v) {
                Py_DECREF(lst);
                return NULL;
            }
            if (tag == 't')
                PyTuple_SET_ITEM(lst, i, v);
            else
                PyList_SET_ITEM(lst, i, v);
        }
        if (tag == 'S') {
            PyObject *s = PySet_New(lst);
            Py_DECREF(lst);
            return s; /* TypeError (unhashable) -> wrapper fallback */
        }
        return lst;
    }
    case 'm': {
        uint64_t n;
        if (rb_varint(r, &n) < 0)
            return NULL;
        if (n > W_MAX_CONTAINER) {
            PyErr_SetString(PyExc_ValueError, "container too large");
            return NULL;
        }
        PyObject *d = PyDict_New();
        if (!d)
            return NULL;
        for (uint64_t i = 0; i < n; i++) {
            PyObject *k = dec_value(r, depth + 1);
            if (!k) {
                Py_DECREF(d);
                return NULL;
            }
            PyObject *v = dec_value(r, depth + 1);
            if (!v) {
                Py_DECREF(k);
                Py_DECREF(d);
                return NULL;
            }
            int rc = PyDict_SetItem(d, k, v);
            Py_DECREF(k);
            Py_DECREF(v);
            if (rc < 0) {
                Py_DECREF(d);
                return NULL;
            }
        }
        return d;
    }
    case 'E': {
        uint64_t tid, u;
        if (rb_varint(r, &tid) < 0 || rb_varint(r, &u) < 0)
            return NULL;
        long long v = (long long)((u >> 1) ^ (~(u & 1) + 1));
        PyObject *idobj = PyLong_FromUnsignedLongLong(tid);
        if (!idobj)
            return NULL;
        PyObject *entry = g_by_id ? PyDict_GetItem(g_by_id, idobj) : NULL;
        Py_DECREF(idobj);
        if (!entry) {
            PyErr_SetString(PyExc_ValueError, "unknown enum id");
            return NULL;
        }
        PyObject *cls = PyTuple_GET_ITEM(entry, 0);
        PyObject *vobj = PyLong_FromLongLong(v);
        if (!vobj)
            return NULL;
        /* member cache from the registry: calling an enum class goes
           through the metaclass (__call__ -> __new__ -> value lookup),
           measurable at per-mutation decode frequency */
        if (PyTuple_GET_SIZE(entry) >= 3) {
            PyObject *memo = PyTuple_GET_ITEM(entry, 2);
            if (PyDict_Check(memo)) {
                PyObject *member = PyDict_GetItem(memo, vobj);
                if (member) {
                    Py_DECREF(vobj);
                    return Py_NewRef(member);
                }
            }
        }
        PyObject *out = PyObject_CallOneArg(cls, vobj);
        Py_DECREF(vobj);
        return out; /* ValueError (bad member) -> wrapper fallback keeps
                       canonical WireError */
    }
    case 'R': {
        uint64_t tid, n;
        if (rb_varint(r, &tid) < 0 || rb_varint(r, &n) < 0)
            return NULL;
        if (n > 256) {
            PyErr_SetString(PyExc_ValueError, "struct too wide");
            return NULL;
        }
        PyObject *idobj = PyLong_FromUnsignedLongLong(tid);
        if (!idobj)
            return NULL;
        PyObject *entry = g_by_id ? PyDict_GetItem(g_by_id, idobj) : NULL;
        Py_DECREF(idobj);
        if (!entry) {
            PyErr_SetString(PyExc_ValueError, "unknown struct id");
            return NULL;
        }
        PyObject *cls = PyTuple_GET_ITEM(entry, 0);
        PyObject *names = PyTuple_GET_ITEM(entry, 1);
        if (names == Py_None ||
            (Py_ssize_t)n != PyTuple_GET_SIZE(names)) {
            /* schema skew (old/new peer): Python decoder handles defaults */
            PyErr_SetString(PyExc_OverflowError, "schema skew");
            return NULL;
        }
        /* fast construction for vanilla dataclasses (registry-flagged:
           generated __init__, no __post_init__, no __slots__): allocate and
           stuff the instance dict directly, the same bypass pickle uses.
           Field order in `names` IS the generated __init__'s assignment
           order, so the result is bit-identical to calling the class. */
        if (PyTuple_GET_SIZE(entry) >= 3 &&
            PyTuple_GET_ITEM(entry, 2) == Py_True &&
            ((PyTypeObject *)cls)->tp_dictoffset > 0) {
            PyTypeObject *tp = (PyTypeObject *)cls;
            PyObject *obj = tp->tp_alloc(tp, 0);
            if (!obj)
                return NULL;
            PyObject **dictptr = _PyObject_GetDictPtr(obj);
            PyObject *d = PyDict_New();
            if (!dictptr || !d) {
                Py_XDECREF(d);
                Py_DECREF(obj);
                if (!dictptr)
                    PyErr_SetString(PyExc_SystemError, "no instance dict");
                return NULL;
            }
            *dictptr = d;
            for (uint64_t i = 0; i < n; i++) {
                PyObject *v = dec_value(r, depth + 1);
                if (!v ||
                    PyDict_SetItem(d, PyTuple_GET_ITEM(names, i), v) < 0) {
                    Py_XDECREF(v);
                    Py_DECREF(obj);
                    return NULL;
                }
                Py_DECREF(v);
            }
            return obj;
        }
        PyObject *args = PyTuple_New(n);
        if (!args)
            return NULL;
        for (uint64_t i = 0; i < n; i++) {
            PyObject *v = dec_value(r, depth + 1);
            if (!v) {
                Py_DECREF(args);
                return NULL;
            }
            PyTuple_SET_ITEM(args, i, v);
        }
        PyObject *out = PyObject_CallObject(cls, args);
        Py_DECREF(args);
        return out;
    }
    default:
        PyErr_Format(PyExc_ValueError, "unknown tag %#x", tag);
        return NULL;
    }
}

static PyObject *py_wire_loads(PyObject *self, PyObject *arg) {
    Py_buffer data;
    if (PyObject_GetBuffer(arg, &data, PyBUF_SIMPLE) < 0)
        return NULL;
    RBuf r = {(const uint8_t *)data.buf,
              (const uint8_t *)data.buf + data.len};
    if (data.len < 2 || r.p[0] != W_MAGIC || r.p[1] > W_VERSION) {
        PyBuffer_Release(&data);
        PyErr_SetString(PyExc_ValueError, "bad magic/version");
        return NULL;
    }
    r.p += 2;
    PyObject *out = dec_value(&r, 0);
    if (out && r.p != r.end) {
        Py_DECREF(out);
        out = NULL;
        PyErr_SetString(PyExc_ValueError, "trailing bytes");
    }
    PyBuffer_Release(&data);
    return out;
}

/* ------------------------------------------------------------------ */
/* Conflict-batch flattening                                           */
/*                                                                     */
/* The card's feed path: one C pass walks a chunk of transaction       */
/* conflict infos and writes the whole packed batch buffer the engine  */
/* copies to the card (ops/step_graph.py batch_layout): begin/end keys */
/* as the port's signed limbs (SoA), range->txn maps, snapshots and    */
/* valid flags, padding included. Replaces a per-txn Python loop plus  */
/* numpy that dominated the resolver's host cost at serving sizes.     */
/* ------------------------------------------------------------------ */

#define PAD_LIMB_BITS 0x7FFFFFFFu /* ops/conflict_ref.py PAD_LIMB */
#define SIGN_FLIP 0x80000000u     /* utils/keys.py to_signed_limbs */
#define NEG_OFFSET (-1073741824LL) /* ops/conflict_ref.py NEG */

static void fill_u32(uint32_t *o, Py_ssize_t n, uint32_t v) {
    for (Py_ssize_t i = 0; i < n; i++)
        o[i] = v;
}

/* encode one key into column `col`, then flip each limb's sign bit: the
 * port's order-preserving int32 limbs */
static int encode_key_col_signed(PyObject *keyobj, uint32_t *o,
                                 Py_ssize_t cap, int num_limbs, int key_bytes,
                                 int round_up, Py_ssize_t col) {
    if (encode_key_col(keyobj, o, cap, num_limbs, key_bytes, round_up, col)
            < 0)
        return -1;
    for (int l = 0; l < num_limbs; l++)
        o[(Py_ssize_t)l * cap + col] ^= SIGN_FLIP;
    return 0;
}

/* a txn's read_snapshot as the engine's clamped int32 offset from
 * base_version (ops/conflict.py BatchEncoder._clamp_off) */
static int snapshot_offset(PyObject *txn, long long base_version,
                           int32_t *out) {
    PyObject *rs = PyObject_GetAttrString(txn, "read_snapshot");
    if (!rs)
        return -1;
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(rs, &overflow);
    Py_DECREF(rs);
    if (v == -1 && PyErr_Occurred())
        return -1;
    __int128 off = overflow > 0   ? (__int128)2147483647LL
                   : overflow < 0 ? (__int128)NEG_OFFSET
                                  : (__int128)v - base_version;
    if (off > 2147483647LL)
        off = 2147483647LL;
    if (off < NEG_OFFSET)
        off = NEG_OFFSET;
    *out = (int32_t)off;
    return 0;
}

/* encode_conflict_ranges(txns, skip_or_None, rb, re, wb, we, rtxn, wtxn,
 *                        key_bytes, snap, valid, base_version,
 *                        rstride, wstride) -> (n_reads, n_writes)
 * txns: sequence of at most T objects with .read_snapshot and
 * .read_ranges/.write_ranges = [(b, e), ...]; skip[t] true leaves txn t
 * out (the host decided it TOO_OLD).
 * rb/re/wb/we: writable int32 buffers (num_limbs x cap, limb-major);
 * rtxn/wtxn: writable int32 buffers (cap); snap: int32 (T), which gives T;
 * valid: uint8 (T). Every element of every buffer is written: the pass
 * first fills the padding (PAD_LIMB keys; owners T, or slot / stride;
 * snapshot and valid 0), then each unskipped txn's fields. rstride and
 * wstride are 0 for the pooled layout (ranges packed in order), else the
 * strided layout's ranges a txn (range i of txn t at slot t * stride + i;
 * cap must be T * stride). Raises ValueError on overflow of a capacity or
 * a stride, or on buffers that disagree on their sizes. */
static PyObject *py_encode_conflict_ranges(PyObject *self, PyObject *args) {
    PyObject *txns, *skip;
    Py_buffer rb, re, wb, we, rtxn, wtxn, snap, valid;
    long long base_version = 0;
    int key_bytes = KEY_BYTES;
    Py_ssize_t rstride = 0, wstride = 0;
    if (!PyArg_ParseTuple(args, "OOw*w*w*w*w*w*iw*w*Lnn", &txns, &skip, &rb,
                          &re, &wb, &we, &rtxn, &wtxn, &key_bytes, &snap,
                          &valid, &base_version, &rstride, &wstride))
        return NULL;
    PyObject *seq = NULL;
    PyObject *skipf = NULL;
    PyObject *ret = NULL;
    if (check_key_bytes(key_bytes) < 0)
        goto done;
    int num_limbs = key_bytes / 4 + 1;
    Py_ssize_t rcap = rb.len / (4 * num_limbs);
    Py_ssize_t wcap = wb.len / (4 * num_limbs);
    Py_ssize_t T = snap.len / 4;
    /* every sibling buffer must cover its capacity — rcap/wcap are derived
     * from rb/wb alone, and writing past a smaller re/we/rtxn/wtxn would be
     * heap corruption, not an exception */
    if (re.len < rcap * 4 * num_limbs || we.len < wcap * 4 * num_limbs ||
        (Py_ssize_t)rtxn.len < rcap * 4 || (Py_ssize_t)wtxn.len < wcap * 4 ||
        (Py_ssize_t)valid.len < T) {
        PyErr_SetString(PyExc_ValueError, "output buffers disagree on size");
        goto done;
    }
    if (rstride < 0 || wstride < 0 || (rstride > 0) != (wstride > 0) ||
        (rstride > 0 && (rcap != T * rstride || wcap != T * wstride))) {
        PyErr_SetString(PyExc_ValueError,
                        "strides disagree with the buffers' capacities");
        goto done;
    }
    int32_t *rt = (int32_t *)rtxn.buf;
    int32_t *wt = (int32_t *)wtxn.buf;
    int32_t *sn = (int32_t *)snap.buf;
    uint8_t *vl = (uint8_t *)valid.buf;
    seq = PySequence_Fast(txns, "txns must be a sequence");
    if (!seq)
        goto done;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (n > T) {
        PyErr_SetString(PyExc_ValueError, "more txns than the chunk holds");
        goto done;
    }
    if (skip != Py_None) {
        skipf = PySequence_Fast(skip, "skip must be a sequence");
        if (!skipf)
            goto done;
    }
    /* the skip mask is indexed by t below: a short one would read past
     * its item array, not raise */
    if (skipf && PySequence_Fast_GET_SIZE(skipf) < n) {
        PyErr_SetString(PyExc_ValueError, "skip mask shorter than txns");
        goto done;
    }
    /* the padding: what the numpy encoder's fills write */
    fill_u32((uint32_t *)rb.buf, rcap * num_limbs, PAD_LIMB_BITS);
    fill_u32((uint32_t *)re.buf, rcap * num_limbs, PAD_LIMB_BITS);
    fill_u32((uint32_t *)wb.buf, wcap * num_limbs, PAD_LIMB_BITS);
    fill_u32((uint32_t *)we.buf, wcap * num_limbs, PAD_LIMB_BITS);
    for (Py_ssize_t i = 0; i < rcap; i++)
        rt[i] = (int32_t)(rstride > 0 ? i / rstride : T);
    for (Py_ssize_t i = 0; i < wcap; i++)
        wt[i] = (int32_t)(wstride > 0 ? i / wstride : T);
    memset(sn, 0, (size_t)T * 4);
    memset(vl, 0, (size_t)T);
    Py_ssize_t ri = 0, wi = 0;
    for (Py_ssize_t t = 0; t < n; t++) {
        if (skipf) {
            int truth = PyObject_IsTrue(PySequence_Fast_GET_ITEM(skipf, t));
            if (truth < 0)
                goto done;
            if (truth)
                continue;
        }
        PyObject *txn = PySequence_Fast_GET_ITEM(seq, t);
        if (snapshot_offset(txn, base_version, &sn[t]) < 0)
            goto done;
        vl[t] = 1;
        for (int pass = 0; pass < 2; pass++) {
            PyObject *ranges = PyObject_GetAttrString(
                txn, pass == 0 ? "read_ranges" : "write_ranges");
            if (!ranges)
                goto done;
            PyObject *rseq = PySequence_Fast(ranges, "ranges");
            Py_DECREF(ranges);
            if (!rseq)
                goto done;
            Py_ssize_t nr = PySequence_Fast_GET_SIZE(rseq);
            uint32_t *ob = pass == 0 ? (uint32_t *)rb.buf : (uint32_t *)wb.buf;
            uint32_t *oe = pass == 0 ? (uint32_t *)re.buf : (uint32_t *)we.buf;
            Py_ssize_t cap = pass == 0 ? rcap : wcap;
            Py_ssize_t stride = pass == 0 ? rstride : wstride;
            Py_ssize_t *idx = pass == 0 ? &ri : &wi;
            int32_t *map = pass == 0 ? rt : wt;
            if (stride > 0 ? nr > stride : *idx + nr > cap) {
                Py_DECREF(rseq);
                PyErr_SetString(PyExc_ValueError,
                                stride > 0 ? "conflict range stride exceeded"
                                           : "conflict range capacity exceeded");
                goto done;
            }
            for (Py_ssize_t j = 0; j < nr; j++) {
                PyObject *pair = PySequence_Fast_GET_ITEM(rseq, j);
                PyObject *kb, *ke;
                if (PyTuple_CheckExact(pair) && PyTuple_GET_SIZE(pair) == 2) {
                    kb = PyTuple_GET_ITEM(pair, 0);
                    ke = PyTuple_GET_ITEM(pair, 1);
                } else if (PyList_CheckExact(pair) &&
                           PyList_GET_SIZE(pair) == 2) {
                    kb = PyList_GET_ITEM(pair, 0);
                    ke = PyList_GET_ITEM(pair, 1);
                } else {
                    Py_DECREF(rseq);
                    PyErr_SetString(PyExc_TypeError,
                                    "range must be a (begin, end) pair");
                    goto done;
                }
                Py_ssize_t col = stride > 0 ? t * stride + j : *idx;
                if (encode_key_col_signed(kb, ob, cap, num_limbs, key_bytes, 0,
                                          col) < 0 ||
                    encode_key_col_signed(ke, oe, cap, num_limbs, key_bytes, 1,
                                          col) < 0) {
                    Py_DECREF(rseq);
                    goto done;
                }
                if (stride == 0)
                    map[col] = (int32_t)t;
                (*idx)++;
            }
            Py_DECREF(rseq);
        }
    }
    ret = Py_BuildValue("(nn)", ri, wi);
done:
    Py_XDECREF(seq);
    Py_XDECREF(skipf);
    PyBuffer_Release(&rb);
    PyBuffer_Release(&re);
    PyBuffer_Release(&wb);
    PyBuffer_Release(&we);
    PyBuffer_Release(&rtxn);
    PyBuffer_Release(&wtxn);
    PyBuffer_Release(&snap);
    PyBuffer_Release(&valid);
    return ret;
}

/* ------------------------------------------------------------------ */
/* IndexedSet: ordered bytes->metric map with count+sum augmentation    */
/*                                                                     */
/* The flow/IndexedSet.h analogue: O(log n) insert/erase/rank/nth and  */
/* O(log n) metric sums over arbitrary key ranges (the structure       */
/* storage byte-sampling and shard metrics hang off). A deterministic  */
/* per-instance xorshift drives levels, so sim runs replay exactly.    */
/* ------------------------------------------------------------------ */

#define OM_MAX_LEVEL 32

typedef struct OMNode {
    PyObject *key; /* owned bytes */
    int64_t metric;
    int level;
    struct OMLink {
        struct OMNode *next;
        int64_t cnt; /* level-0 nodes in (this, next] */
        int64_t sum; /* their metrics */
    } ln[1];
} OMNode;

typedef struct {
    PyObject_HEAD
    OMNode *head;
    int cur_level;
    Py_ssize_t n;
    uint64_t rng;
} OMap;

static int om_keycmp(PyObject *a, PyObject *b) {
    Py_ssize_t la = PyBytes_GET_SIZE(a), lb = PyBytes_GET_SIZE(b);
    Py_ssize_t m = la < lb ? la : lb;
    int c = memcmp(PyBytes_AS_STRING(a), PyBytes_AS_STRING(b), m);
    if (c)
        return c;
    return la < lb ? -1 : (la > lb ? 1 : 0);
}

static OMNode *om_node_new(PyObject *key, int64_t metric, int level) {
    OMNode *x = malloc(sizeof(OMNode) + (level - 1) * sizeof(struct OMLink));
    if (!x)
        return NULL;
    Py_XINCREF(key);
    x->key = key;
    x->metric = metric;
    x->level = level;
    memset(x->ln, 0, level * sizeof(struct OMLink));
    return x;
}

static int om_rand_level(OMap *self) {
    uint64_t r = self->rng;
    r ^= r << 13;
    r ^= r >> 7;
    r ^= r << 17;
    self->rng = r;
    int lv = 1;
    while ((r & 3) == 3 && lv < OM_MAX_LEVEL) {
        lv++;
        r >>= 2;
    }
    return lv;
}

/* descend to the last node with key < target at every level, tracking the
 * (count, sum) prefix from head to update[l] */
static void om_descend(OMap *self, PyObject *target, OMNode **update,
                       int64_t *pcnt, int64_t *psum) {
    OMNode *x = self->head;
    int64_t c = 0, s = 0;
    for (int l = self->cur_level - 1; l >= 0; l--) {
        while (x->ln[l].next && om_keycmp(x->ln[l].next->key, target) < 0) {
            c += x->ln[l].cnt;
            s += x->ln[l].sum;
            x = x->ln[l].next;
        }
        update[l] = x;
        pcnt[l] = c;
        psum[l] = s;
    }
    for (int l = self->cur_level; l < OM_MAX_LEVEL; l++) {
        update[l] = self->head;
        pcnt[l] = 0;
        psum[l] = 0;
    }
}

static void om_erase_node(OMap *self, OMNode **update, OMNode *node) {
    for (int l = 0; l < node->level; l++) {
        update[l]->ln[l].cnt += node->ln[l].cnt - 1;
        update[l]->ln[l].sum += node->ln[l].sum - node->metric;
        update[l]->ln[l].next = node->ln[l].next;
    }
    for (int l = node->level; l < self->cur_level; l++) {
        if (update[l]->ln[l].next) {
            update[l]->ln[l].cnt -= 1;
            update[l]->ln[l].sum -= node->metric;
        }
    }
    Py_DECREF(node->key);
    free(node);
    self->n--;
}

static PyObject *om_insert(OMap *self, PyObject *args) {
    PyObject *key;
    long long metric = 1;
    if (!PyArg_ParseTuple(args, "S|L", &key, &metric))
        return NULL;
    OMNode *update[OM_MAX_LEVEL];
    int64_t pcnt[OM_MAX_LEVEL], psum[OM_MAX_LEVEL];
    om_descend(self, key, update, pcnt, psum);
    OMNode *at = update[0]->ln[0].next;
    if (at && om_keycmp(at->key, key) == 0) {
        /* metric replace: after the strict-less descent, every tracked
         * link (update[l], update[l]->next] with next != NULL contains
         * this node (next is the node itself below its level, a later
         * node above it) — each gets the delta */
        int64_t delta = (int64_t)metric - at->metric;
        if (delta) {
            at->metric += delta;
            for (int l = 0; l < self->cur_level; l++)
                if (update[l]->ln[l].next)
                    update[l]->ln[l].sum += delta;
        }
        Py_RETURN_NONE;
    }
    int lv = om_rand_level(self);
    if (lv > self->cur_level) {
        for (int l = self->cur_level; l < lv; l++) {
            update[l] = self->head;
            pcnt[l] = 0;
            psum[l] = 0;
            /* new top level: head's link spans the whole list (set below
             * for the pass-through fixups to be correct) */
            self->head->ln[l].next = NULL;
            self->head->ln[l].cnt = 0;
            self->head->ln[l].sum = 0;
        }
        self->cur_level = lv;
    }
    OMNode *nb = om_node_new(key, metric, lv);
    if (!nb)
        return PyErr_NoMemory();
    int64_t r0 = pcnt[0], s0 = psum[0];
    for (int l = 0; l < lv; l++) {
        OMNode *next = update[l]->ln[l].next;
        int64_t oc = update[l]->ln[l].cnt, os = update[l]->ln[l].sum;
        int64_t d1c = (r0 - pcnt[l]) + 1;          /* (update[l], nb] */
        int64_t d1s = (s0 - psum[l]) + metric;
        nb->ln[l].next = next;
        if (next) {
            nb->ln[l].cnt = oc - d1c + 1;
            nb->ln[l].sum = os - d1s + metric;
        } else {
            nb->ln[l].cnt = 0;
            nb->ln[l].sum = 0;
        }
        update[l]->ln[l].next = nb;
        update[l]->ln[l].cnt = d1c;
        update[l]->ln[l].sum = d1s;
    }
    for (int l = lv; l < self->cur_level; l++) {
        if (update[l]->ln[l].next) {
            update[l]->ln[l].cnt += 1;
            update[l]->ln[l].sum += metric;
        }
    }
    self->n++;
    Py_RETURN_NONE;
}

static PyObject *om_discard(OMap *self, PyObject *key) {
    if (!PyBytes_Check(key)) {
        PyErr_SetString(PyExc_TypeError, "key must be bytes");
        return NULL;
    }
    OMNode *update[OM_MAX_LEVEL];
    int64_t pcnt[OM_MAX_LEVEL], psum[OM_MAX_LEVEL];
    om_descend(self, key, update, pcnt, psum);
    OMNode *at = update[0]->ln[0].next;
    if (at && om_keycmp(at->key, key) == 0) {
        om_erase_node(self, update, at);
        Py_RETURN_TRUE;
    }
    Py_RETURN_FALSE;
}

static PyObject *om_rank(OMap *self, PyObject *key) {
    if (!PyBytes_Check(key)) {
        PyErr_SetString(PyExc_TypeError, "key must be bytes");
        return NULL;
    }
    OMNode *update[OM_MAX_LEVEL];
    int64_t pcnt[OM_MAX_LEVEL], psum[OM_MAX_LEVEL];
    om_descend(self, key, update, pcnt, psum);
    return PyLong_FromLongLong(pcnt[0]); /* keys strictly < key */
}

static PyObject *om_nth(OMap *self, PyObject *arg) {
    Py_ssize_t i = PyLong_AsSsize_t(arg);
    if (i == -1 && PyErr_Occurred())
        return NULL;
    if (i < 0 || i >= self->n) {
        PyErr_SetString(PyExc_IndexError, "IndexedSet.nth out of range");
        return NULL;
    }
    OMNode *x = self->head;
    int64_t want = i + 1, acc = 0;
    for (int l = self->cur_level - 1; l >= 0; l--) {
        while (x->ln[l].next && acc + x->ln[l].cnt <= want) {
            acc += x->ln[l].cnt;
            x = x->ln[l].next;
            if (acc == want) {
                Py_INCREF(x->key);
                return x->key;
            }
        }
    }
    PyErr_SetString(PyExc_RuntimeError, "IndexedSet corrupt");
    return NULL;
}

static PyObject *om_range_keys(OMap *self, PyObject *args) {
    PyObject *lo, *hi;
    Py_ssize_t limit = 0;
    int reverse = 0;
    if (!PyArg_ParseTuple(args, "SS|np", &lo, &hi, &limit, &reverse))
        return NULL;
    OMNode *update[OM_MAX_LEVEL];
    int64_t pcnt[OM_MAX_LEVEL], psum[OM_MAX_LEVEL];
    PyObject *out = PyList_New(0);
    if (!out)
        return NULL;
    if (!reverse) {
        om_descend(self, lo, update, pcnt, psum);
        OMNode *x = update[0]->ln[0].next;
        while (x && om_keycmp(x->key, hi) < 0) {
            if (PyList_Append(out, x->key) < 0) {
                Py_DECREF(out);
                return NULL;
            }
            if (limit && PyList_GET_SIZE(out) >= limit)
                break;
            x = x->ln[0].next;
        }
        return out;
    }
    /* reverse: walk the bounded window forward from a rank, then flip */
    om_descend(self, lo, update, pcnt, psum);
    int64_t r_lo = pcnt[0];
    om_descend(self, hi, update, pcnt, psum);
    int64_t r_hi = pcnt[0];
    int64_t start = r_lo;
    if (limit && r_hi - r_lo > limit)
        start = r_hi - limit;
    if (start < r_hi) {
        PyObject *idx = PyLong_FromLongLong(start);
        if (!idx) {
            Py_DECREF(out);
            return NULL;
        }
        PyObject *first = om_nth(self, idx);
        Py_DECREF(idx);
        if (!first) {
            Py_DECREF(out);
            return NULL;
        }
        om_descend(self, first, update, pcnt, psum);
        Py_DECREF(first);
        OMNode *x = update[0]->ln[0].next;
        int64_t todo = r_hi - start;
        while (x && todo-- > 0) {
            if (PyList_Append(out, x->key) < 0) {
                Py_DECREF(out);
                return NULL;
            }
            x = x->ln[0].next;
        }
        if (PyList_Reverse(out) < 0) {
            Py_DECREF(out);
            return NULL;
        }
    }
    return out;
}

static PyObject *om_sum_range(OMap *self, PyObject *args) {
    PyObject *lo, *hi;
    if (!PyArg_ParseTuple(args, "SS", &lo, &hi))
        return NULL;
    OMNode *update[OM_MAX_LEVEL];
    int64_t pcnt[OM_MAX_LEVEL], psum[OM_MAX_LEVEL];
    om_descend(self, lo, update, pcnt, psum);
    int64_t c0 = pcnt[0], s0 = psum[0];
    /* prefix(<lo) must not count a node EQUAL to lo; om_descend is strict-
     * less, so pcnt[0] is exactly the count of keys < lo */
    om_descend(self, hi, update, pcnt, psum);
    return Py_BuildValue("(LL)", (long long)(pcnt[0] - c0),
                         (long long)(psum[0] - s0));
}

static PyObject *om_contains(OMap *self, PyObject *key) {
    OMNode *update[OM_MAX_LEVEL];
    int64_t pcnt[OM_MAX_LEVEL], psum[OM_MAX_LEVEL];
    if (!PyBytes_Check(key))
        Py_RETURN_FALSE;
    om_descend(self, key, update, pcnt, psum);
    OMNode *at = update[0]->ln[0].next;
    if (at && om_keycmp(at->key, key) == 0)
        Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static Py_ssize_t om_len(PyObject *op) {
    return ((OMap *)op)->n;
}

static void om_dealloc(OMap *self) {
    OMNode *x = self->head->ln[0].next;
    while (x) {
        OMNode *nx = x->ln[0].next;
        Py_DECREF(x->key);
        free(x);
        x = nx;
    }
    free(self->head);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *om_new(PyTypeObject *type, PyObject *args, PyObject *kwds) {
    OMap *self = (OMap *)type->tp_alloc(type, 0);
    if (!self)
        return NULL;
    self->head = om_node_new(NULL, 0, OM_MAX_LEVEL);
    if (!self->head) {
        Py_TYPE(self)->tp_free((PyObject *)self);
        return PyErr_NoMemory();
    }
    self->cur_level = 1;
    self->n = 0;
    self->rng = 0x9E3779B97F4A7C15ULL;
    return (PyObject *)self;
}

static PyMethodDef om_methods[] = {
    {"insert", (PyCFunction)om_insert, METH_VARARGS,
     "insert(key, metric=1): add or re-metric a key"},
    {"discard", (PyCFunction)om_discard, METH_O,
     "discard(key) -> bool: remove if present"},
    {"rank", (PyCFunction)om_rank, METH_O,
     "rank(key) -> number of keys < key (bisect_left)"},
    {"nth", (PyCFunction)om_nth, METH_O, "nth(i) -> i-th smallest key"},
    {"range_keys", (PyCFunction)om_range_keys, METH_VARARGS,
     "range_keys(lo, hi, limit=0, reverse=False) -> [keys in [lo, hi))]"},
    {"sum_range", (PyCFunction)om_sum_range, METH_VARARGS,
     "sum_range(lo, hi) -> (count, metric_sum) over [lo, hi)"},
    {"contains", (PyCFunction)om_contains, METH_O, "membership"},
    {NULL, NULL, 0, NULL}};

static PySequenceMethods om_as_sequence = {
    .sq_length = om_len,
};

static PyTypeObject OMapType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "fdb_native.IndexedSet",
    .tp_basicsize = sizeof(OMap),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = om_new,
    .tp_dealloc = (destructor)om_dealloc,
    .tp_methods = om_methods,
    .tp_as_sequence = &om_as_sequence,
    .tp_doc = "count+sum-augmented ordered bytes map (flow/IndexedSet.h)",
};

/* ------------------------------------------------------------------ */
/* VStore: the storage server's MVCC read path                         */
/*                                                                     */
/* The VersionedMap.h analogue serving reads at any version inside the */
/* MVCC window. Keys live in a cnt-augmented skiplist (same shape as   */
/* IndexedSet above); each node carries the key's version chain as     */
/* parallel arrays (int64 versions ascending, owned PyObject values,   */
/* Py_None = tombstone). Point gets bisect the chain; range reads walk */
/* level 0 with limit/byte-limit semantics; key selectors resolve      */
/* in-C; and the *_encode methods emit a complete utils/wire.py reply  */
/* frame (GetValuesReply / GetKeyValuesReply) in one pass, so a remote */
/* read reply never round-trips through per-KV Python encoding.        */
/*                                                                     */
/* Version policy (oldest/latest tracking, order enforcement) stays in */
/* the Python wrapper (server/versioned_map.py NativeVersionedMap),    */
/* which is chosen by make_versioned_map() with the pure-Python        */
/* VersionedMap as the parity-fuzzed fallback.                         */
/* ------------------------------------------------------------------ */

typedef struct {
    int64_t *versions;  /* ascending */
    PyObject **values;  /* owned; Py_None = tombstone */
    Py_ssize_t n, cap;
} VChain;

typedef struct VSNode {
    PyObject *key; /* owned bytes; NULL for head */
    VChain ch;
    int level;
    struct VSLink {
        struct VSNode *next;
        int64_t cnt; /* level-0 nodes in (this, next] */
    } ln[1];
} VSNode;

typedef struct {
    PyObject_HEAD
    VSNode *head;
    int cur_level;
    Py_ssize_t n;
    uint64_t rng;
    int64_t bytes; /* byte_size(): sum len(key) + per-entry len(value)+16 */
} VStore;

/* shared constants built at module init */
static PyObject *g_too_old_pair = NULL; /* (1, "transaction_too_old") */
static PyObject *g_zero = NULL;         /* int 0 */
static PyObject *g_hi32 = NULL;         /* b"\xff" * 32: selector scan end */
static PyObject *g_sel_end = NULL;      /* b"\xff\xff": past-the-end sentinel */
static PyObject *g_sel_begin = NULL;    /* b"": before-the-beginning sentinel */

#define TOO_OLD_NAME "transaction_too_old"

static inline int64_t vs_val_bytes(PyObject *v) {
    return (v == Py_None ? 0 : (int64_t)PyBytes_GET_SIZE(v)) + 16;
}

/* rightmost index with versions[i] <= v, or -1 */
static inline Py_ssize_t chain_bisect(const VChain *c, int64_t v) {
    Py_ssize_t lo = 0, hi = c->n;
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) >> 1;
        if (c->versions[mid] <= v)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo - 1;
}

static int chain_push(VChain *c, int64_t version, PyObject *value) {
    if (c->n == c->cap) {
        Py_ssize_t cap = c->cap ? c->cap * 2 : 4;
        int64_t *nv = PyMem_Realloc(c->versions, cap * sizeof(int64_t));
        if (!nv) {
            PyErr_NoMemory();
            return -1;
        }
        c->versions = nv;
        PyObject **nvals = PyMem_Realloc(c->values, cap * sizeof(PyObject *));
        if (!nvals) {
            PyErr_NoMemory();
            return -1;
        }
        c->values = nvals;
        c->cap = cap;
    }
    c->versions[c->n] = version;
    Py_INCREF(value);
    c->values[c->n] = value;
    c->n++;
    return 0;
}

static VSNode *vs_node_new(PyObject *key, int level) {
    VSNode *x = malloc(sizeof(VSNode) + (level - 1) * sizeof(struct VSLink));
    if (!x)
        return NULL;
    Py_XINCREF(key);
    x->key = key;
    x->level = level;
    memset(&x->ch, 0, sizeof(VChain));
    memset(x->ln, 0, level * sizeof(struct VSLink));
    return x;
}

static void vs_node_free(VSNode *x) {
    for (Py_ssize_t i = 0; i < x->ch.n; i++)
        Py_DECREF(x->ch.values[i]);
    PyMem_Free(x->ch.versions);
    PyMem_Free(x->ch.values);
    Py_XDECREF(x->key);
    free(x);
}

static int vs_rand_level(VStore *self) {
    uint64_t r = self->rng;
    r ^= r << 13;
    r ^= r >> 7;
    r ^= r << 17;
    self->rng = r;
    int lv = 1;
    while ((r & 3) == 3 && lv < OM_MAX_LEVEL) {
        lv++;
        r >>= 2;
    }
    return lv;
}

/* last node with key < target at every level, tracking the count prefix */
static void vs_descend(VStore *self, PyObject *target, VSNode **update,
                       int64_t *pcnt) {
    VSNode *x = self->head;
    int64_t c = 0;
    for (int l = self->cur_level - 1; l >= 0; l--) {
        while (x->ln[l].next && om_keycmp(x->ln[l].next->key, target) < 0) {
            c += x->ln[l].cnt;
            x = x->ln[l].next;
        }
        update[l] = x;
        pcnt[l] = c;
    }
    for (int l = self->cur_level; l < OM_MAX_LEVEL; l++) {
        update[l] = self->head;
        pcnt[l] = 0;
    }
}

static VSNode *vs_search(VStore *self, PyObject *key) {
    VSNode *x = self->head;
    for (int l = self->cur_level - 1; l >= 0; l--)
        while (x->ln[l].next && om_keycmp(x->ln[l].next->key, key) < 0)
            x = x->ln[l].next;
    VSNode *nx = x->ln[0].next;
    if (nx && om_keycmp(nx->key, key) == 0)
        return nx;
    return NULL;
}

/* number of keys strictly < key */
static int64_t vs_rank(VStore *self, PyObject *key) {
    VSNode *x = self->head;
    int64_t c = 0;
    for (int l = self->cur_level - 1; l >= 0; l--) {
        while (x->ln[l].next && om_keycmp(x->ln[l].next->key, key) < 0) {
            c += x->ln[l].cnt;
            x = x->ln[l].next;
        }
    }
    return c;
}

static VSNode *vs_nth(VStore *self, int64_t i) {
    if (i < 0 || i >= (int64_t)self->n)
        return NULL;
    VSNode *x = self->head;
    int64_t want = i + 1, acc = 0;
    for (int l = self->cur_level - 1; l >= 0; l--) {
        while (x->ln[l].next && acc + x->ln[l].cnt <= want) {
            acc += x->ln[l].cnt;
            x = x->ln[l].next;
            if (acc == want)
                return x;
        }
    }
    return NULL; /* unreachable unless corrupt */
}

/* insert a fresh node for `key` (caller knows it is absent) */
static VSNode *vs_insert(VStore *self, PyObject *key) {
    VSNode *update[OM_MAX_LEVEL];
    int64_t pcnt[OM_MAX_LEVEL];
    vs_descend(self, key, update, pcnt);
    int lv = vs_rand_level(self);
    if (lv > self->cur_level) {
        for (int l = self->cur_level; l < lv; l++) {
            update[l] = self->head;
            pcnt[l] = 0;
            self->head->ln[l].next = NULL;
            self->head->ln[l].cnt = 0;
        }
        self->cur_level = lv;
    }
    VSNode *nb = vs_node_new(key, lv);
    if (!nb) {
        PyErr_NoMemory();
        return NULL;
    }
    int64_t r0 = pcnt[0];
    for (int l = 0; l < lv; l++) {
        VSNode *next = update[l]->ln[l].next;
        int64_t oc = update[l]->ln[l].cnt;
        int64_t d1c = (r0 - pcnt[l]) + 1; /* (update[l], nb] */
        nb->ln[l].next = next;
        nb->ln[l].cnt = next ? oc - d1c + 1 : 0;
        update[l]->ln[l].next = nb;
        update[l]->ln[l].cnt = d1c;
    }
    for (int l = lv; l < self->cur_level; l++) {
        if (update[l]->ln[l].next)
            update[l]->ln[l].cnt += 1;
    }
    self->n++;
    return nb;
}

static void vs_erase_node(VStore *self, VSNode **update, VSNode *node) {
    for (int l = 0; l < node->level; l++) {
        update[l]->ln[l].cnt += node->ln[l].cnt - 1;
        update[l]->ln[l].next = node->ln[l].next;
    }
    for (int l = node->level; l < self->cur_level; l++) {
        if (update[l]->ln[l].next)
            update[l]->ln[l].cnt -= 1;
    }
    self->bytes -= PyBytes_GET_SIZE(node->key);
    for (Py_ssize_t i = 0; i < node->ch.n; i++)
        self->bytes -= vs_val_bytes(node->ch.values[i]);
    vs_node_free(node);
    self->n--;
}

static void vs_discard(VStore *self, PyObject *key) {
    VSNode *update[OM_MAX_LEVEL];
    int64_t pcnt[OM_MAX_LEVEL];
    vs_descend(self, key, update, pcnt);
    VSNode *at = update[0]->ln[0].next;
    if (at && om_keycmp(at->key, key) == 0)
        vs_erase_node(self, update, at);
}

/* -- write path (version order enforced by the Python wrapper) -- */

static PyObject *vs_put(VStore *self, PyObject *args) {
    PyObject *key, *value;
    long long version;
    if (!PyArg_ParseTuple(args, "SLO", &key, &version, &value))
        return NULL;
    if (value != Py_None && !PyBytes_Check(value)) {
        PyErr_SetString(PyExc_TypeError, "value must be bytes or None");
        return NULL;
    }
    VSNode *node = vs_search(self, key);
    if (!node) {
        if (value == Py_None)
            Py_RETURN_NONE; /* clearing an absent key is a no-op */
        node = vs_insert(self, key);
        if (!node)
            return NULL;
        self->bytes += PyBytes_GET_SIZE(key);
    }
    VChain *c = &node->ch;
    if (c->n && c->versions[c->n - 1] == version) {
        self->bytes += vs_val_bytes(value) - vs_val_bytes(c->values[c->n - 1]);
        Py_INCREF(value);
        Py_SETREF(c->values[c->n - 1], value);
    } else {
        if (chain_push(c, version, value) < 0)
            return NULL;
        self->bytes += vs_val_bytes(value);
    }
    Py_RETURN_NONE;
}

static PyObject *vs_latest(VStore *self, PyObject *key) {
    if (!PyBytes_Check(key)) {
        PyErr_SetString(PyExc_TypeError, "key must be bytes");
        return NULL;
    }
    VSNode *node = vs_search(self, key);
    if (!node || node->ch.n == 0)
        Py_RETURN_NONE;
    return Py_NewRef(node->ch.values[node->ch.n - 1]);
}

static PyObject *vs_clear_range(VStore *self, PyObject *args) {
    PyObject *begin, *end;
    long long version;
    if (!PyArg_ParseTuple(args, "SSL", &begin, &end, &version))
        return NULL;
    VSNode *x = self->head;
    for (int l = self->cur_level - 1; l >= 0; l--)
        while (x->ln[l].next && om_keycmp(x->ln[l].next->key, begin) < 0)
            x = x->ln[l].next;
    for (x = x->ln[0].next; x && om_keycmp(x->key, end) < 0;
         x = x->ln[0].next) {
        VChain *c = &x->ch;
        if (c->n == 0 || c->values[c->n - 1] == Py_None)
            continue; /* only live keys get a tombstone */
        if (c->versions[c->n - 1] == version) {
            self->bytes += 16 - vs_val_bytes(c->values[c->n - 1]);
            Py_SETREF(c->values[c->n - 1], Py_NewRef(Py_None));
        } else {
            if (chain_push(c, version, Py_None) < 0)
                return NULL;
            self->bytes += 16;
        }
    }
    Py_RETURN_NONE;
}

/* -- read path -- */

static PyObject *vs_get(VStore *self, PyObject *args) {
    PyObject *key;
    long long version;
    if (!PyArg_ParseTuple(args, "SL", &key, &version))
        return NULL;
    VSNode *node = vs_search(self, key);
    if (!node)
        Py_RETURN_NONE;
    Py_ssize_t i = chain_bisect(&node->ch, version);
    if (i < 0)
        Py_RETURN_NONE;
    return Py_NewRef(node->ch.values[i]);
}

/* split one (key, version) item from a reads list */
static int vs_read_item(PyObject *item, PyObject **key, int64_t *version) {
    PyObject *kb, *vb;
    if (PyTuple_CheckExact(item) && PyTuple_GET_SIZE(item) == 2) {
        kb = PyTuple_GET_ITEM(item, 0);
        vb = PyTuple_GET_ITEM(item, 1);
    } else if (PyList_CheckExact(item) && PyList_GET_SIZE(item) == 2) {
        kb = PyList_GET_ITEM(item, 0);
        vb = PyList_GET_ITEM(item, 1);
    } else {
        PyErr_SetString(PyExc_TypeError, "read must be a (key, version) pair");
        return -1;
    }
    if (!PyBytes_Check(kb)) {
        PyErr_SetString(PyExc_TypeError, "key must be bytes");
        return -1;
    }
    long long v = PyLong_AsLongLong(vb);
    if (v == -1 && PyErr_Occurred())
        return -1;
    *key = kb;
    *version = v;
    return 0;
}

static PyObject *vs_get_many(VStore *self, PyObject *args) {
    PyObject *reads;
    long long oldest;
    if (!PyArg_ParseTuple(args, "OL", &reads, &oldest))
        return NULL;
    PyObject *seq = PySequence_Fast(reads, "reads must be a sequence");
    if (!seq)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject *out = PyList_New(n);
    if (!out) {
        Py_DECREF(seq);
        return NULL;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key;
        int64_t version;
        if (vs_read_item(PySequence_Fast_GET_ITEM(seq, i), &key, &version) < 0)
            goto fail;
        PyObject *pair;
        if (version < oldest) {
            pair = Py_NewRef(g_too_old_pair);
        } else {
            PyObject *val = Py_None;
            VSNode *node = vs_search(self, key);
            if (node) {
                Py_ssize_t j = chain_bisect(&node->ch, version);
                if (j >= 0)
                    val = node->ch.values[j];
            }
            pair = PyTuple_Pack(2, g_zero, val);
            if (!pair)
                goto fail;
        }
        PyList_SET_ITEM(out, i, pair);
    }
    Py_DECREF(seq);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(out);
    return NULL;
}

/* -- wire-frame emitters (must byte-match utils/wire.py _py_dumps) -- */

static inline int wb_zigzag(WBuf *w, int64_t v) {
    return wb_varint(w, ((uint64_t)v << 1) ^ (uint64_t)(v >> 63));
}

static inline int wb_bytes_val(WBuf *w, PyObject *v) {
    if (v == Py_None)
        return wb_byte(w, 'N');
    Py_ssize_t n = PyBytes_GET_SIZE(v);
    if (wb_byte(w, 'b') < 0 || wb_varint(w, (uint64_t)n) < 0)
        return -1;
    return wb_raw(w, PyBytes_AS_STRING(v), n);
}

/* get_many_encode(reads, oldest, tid) -> complete GetValuesReply frame */
static PyObject *vs_get_many_encode(VStore *self, PyObject *args) {
    PyObject *reads;
    long long oldest;
    unsigned long long tid;
    if (!PyArg_ParseTuple(args, "OLK", &reads, &oldest, &tid))
        return NULL;
    PyObject *seq = PySequence_Fast(reads, "reads must be a sequence");
    if (!seq)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    WBuf w = {NULL, 0, 0};
    if (wb_grow(&w, 64 + n * 24) < 0)
        goto fail;
    w.buf[w.len++] = W_MAGIC;
    w.buf[w.len++] = W_VERSION;
    /* GetValuesReply { results: [(0, value|None) | (1, errname)] } */
    if (wb_byte(&w, 'R') < 0 || wb_varint(&w, tid) < 0 ||
        wb_varint(&w, 1) < 0 || wb_byte(&w, 'l') < 0 ||
        wb_varint(&w, (uint64_t)n) < 0)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key;
        int64_t version;
        if (vs_read_item(PySequence_Fast_GET_ITEM(seq, i), &key, &version) < 0)
            goto fail;
        if (wb_byte(&w, 't') < 0 || wb_varint(&w, 2) < 0)
            goto fail;
        if (version < oldest) {
            size_t elen = strlen(TOO_OLD_NAME);
            if (wb_byte(&w, 'i') < 0 || wb_varint(&w, 2) < 0 || /* int 1 */
                wb_byte(&w, 's') < 0 || wb_varint(&w, elen) < 0 ||
                wb_raw(&w, TOO_OLD_NAME, elen) < 0)
                goto fail;
        } else {
            PyObject *val = Py_None;
            VSNode *node = vs_search(self, key);
            if (node) {
                Py_ssize_t j = chain_bisect(&node->ch, version);
                if (j >= 0)
                    val = node->ch.values[j];
            }
            if (wb_byte(&w, 'i') < 0 || wb_varint(&w, 0) < 0 || /* int 0 */
                wb_bytes_val(&w, val) < 0)
                goto fail;
        }
    }
    Py_DECREF(seq);
    PyObject *out = PyBytes_FromStringAndSize((const char *)w.buf, w.len);
    PyMem_Free(w.buf);
    return out;
fail:
    Py_DECREF(seq);
    PyMem_Free(w.buf);
    return NULL;
}

/* Range scan core: calls emit(ctx, key, value) for each live pair in
 * [begin, end) at `version` honoring limit/limit_bytes; *more is set when a
 * limit cut the scan short AND a live key remains (the Python
 * range_read/_has_live_after semantics). Returns 0, or -1 on emit failure. */
typedef int (*vs_emit_fn)(void *ctx, PyObject *key, PyObject *val);

static int vs_scan(VStore *self, PyObject *begin, PyObject *end,
                   int64_t version, Py_ssize_t limit, Py_ssize_t limit_bytes,
                   int reverse, vs_emit_fn emit, void *ctx, int *more) {
    *more = 0;
    Py_ssize_t count = 0;
    int64_t total = 0;
    if (!reverse) {
        VSNode *x = self->head;
        for (int l = self->cur_level - 1; l >= 0; l--)
            while (x->ln[l].next && om_keycmp(x->ln[l].next->key, begin) < 0)
                x = x->ln[l].next;
        x = x->ln[0].next;
        for (; x && om_keycmp(x->key, end) < 0; x = x->ln[0].next) {
            Py_ssize_t i = chain_bisect(&x->ch, version);
            PyObject *v = i >= 0 ? x->ch.values[i] : Py_None;
            if (v == Py_None)
                continue;
            if (emit(ctx, x->key, v) < 0)
                return -1;
            count++;
            total += PyBytes_GET_SIZE(x->key) + PyBytes_GET_SIZE(v);
            if ((limit && count >= limit) ||
                (limit_bytes && total >= limit_bytes)) {
                /* a limit fired: is anything live left in the range? */
                for (x = x->ln[0].next;
                     x && om_keycmp(x->key, end) < 0; x = x->ln[0].next) {
                    Py_ssize_t j = chain_bisect(&x->ch, version);
                    if (j >= 0 && x->ch.values[j] != Py_None) {
                        *more = 1;
                        break;
                    }
                }
                return 0;
            }
        }
        return 0;
    }
    /* reverse: rank-based backward walk (skiplists have no back links);
     * O(k log n) per emitted key — reverse reads are rare and bounded */
    int64_t idx = vs_rank(self, end) - 1;
    int64_t lo = vs_rank(self, begin);
    for (; idx >= lo; idx--) {
        VSNode *x = vs_nth(self, idx);
        if (!x)
            break;
        Py_ssize_t i = chain_bisect(&x->ch, version);
        PyObject *v = i >= 0 ? x->ch.values[i] : Py_None;
        if (v == Py_None)
            continue;
        if (emit(ctx, x->key, v) < 0)
            return -1;
        count++;
        total += PyBytes_GET_SIZE(x->key) + PyBytes_GET_SIZE(v);
        if ((limit && count >= limit) || (limit_bytes && total >= limit_bytes)) {
            for (idx--; idx >= lo; idx--) {
                VSNode *y = vs_nth(self, idx);
                if (!y)
                    break;
                Py_ssize_t j = chain_bisect(&y->ch, version);
                if (j >= 0 && y->ch.values[j] != Py_None) {
                    *more = 1;
                    break;
                }
            }
            return 0;
        }
    }
    return 0;
}

static int vs_emit_list(void *ctx, PyObject *key, PyObject *val) {
    PyObject *pair = PyTuple_Pack(2, key, val);
    if (!pair)
        return -1;
    int rc = PyList_Append((PyObject *)ctx, pair);
    Py_DECREF(pair);
    return rc;
}

/* wire-emit context: pairs are encoded into a side buffer while counting
 * them, because the 'l' list header needs the count before the items */
struct vs_wire_ctx {
    WBuf *w;
    Py_ssize_t count;
};

static int vs_emit_wire(void *ctxp, PyObject *key, PyObject *val) {
    struct vs_wire_ctx *ctx = (struct vs_wire_ctx *)ctxp;
    WBuf *w = ctx->w;
    ctx->count++;
    if (wb_byte(w, 't') < 0 || wb_varint(w, 2) < 0)
        return -1;
    if (wb_bytes_val(w, key) < 0 || wb_bytes_val(w, val) < 0)
        return -1;
    return 0;
}

static PyObject *vs_range_read(VStore *self, PyObject *args) {
    PyObject *begin, *end;
    long long version;
    Py_ssize_t limit = 0, limit_bytes = 0;
    int reverse = 0;
    if (!PyArg_ParseTuple(args, "SSL|nnp", &begin, &end, &version, &limit,
                          &limit_bytes, &reverse))
        return NULL;
    PyObject *out = PyList_New(0);
    if (!out)
        return NULL;
    int more = 0;
    if (vs_scan(self, begin, end, version, limit, limit_bytes, reverse,
                vs_emit_list, out, &more) < 0) {
        Py_DECREF(out);
        return NULL;
    }
    PyObject *ret = Py_BuildValue("(NO)", out, more ? Py_True : Py_False);
    if (!ret)
        Py_DECREF(out);
    return ret;
}

/* range_read_encode(begin, end, version, limit, limit_bytes, reverse, tid)
 * -> complete GetKeyValuesReply{data, more, version} frame */
static PyObject *vs_range_read_encode(VStore *self, PyObject *args) {
    PyObject *begin, *end;
    long long version;
    Py_ssize_t limit = 0, limit_bytes = 0;
    int reverse = 0;
    unsigned long long tid = 0;
    if (!PyArg_ParseTuple(args, "SSLnnpK", &begin, &end, &version, &limit,
                          &limit_bytes, &reverse, &tid))
        return NULL;
    /* pairs go to a side buffer first: the 'l' header needs their count */
    WBuf items = {NULL, 0, 0};
    if (wb_grow(&items, 256) < 0)
        return NULL;
    struct vs_wire_ctx cctx = {&items, 0};
    int more = 0;
    if (vs_scan(self, begin, end, version, limit, limit_bytes, reverse,
                vs_emit_wire, &cctx, &more) < 0) {
        PyMem_Free(items.buf);
        return NULL;
    }
    WBuf w = {NULL, 0, 0};
    if (wb_grow(&w, 32 + items.len) < 0) {
        PyMem_Free(items.buf);
        return NULL;
    }
    w.buf[w.len++] = W_MAGIC;
    w.buf[w.len++] = W_VERSION;
    /* GetKeyValuesReply { data: [(k, v)], more: bool, version: int } */
    if (wb_byte(&w, 'R') < 0 || wb_varint(&w, tid) < 0 ||
        wb_varint(&w, 3) < 0 || wb_byte(&w, 'l') < 0 ||
        wb_varint(&w, (uint64_t)cctx.count) < 0 ||
        wb_raw(&w, (const char *)items.buf, items.len) < 0 ||
        wb_byte(&w, more ? 'T' : 'F') < 0 || wb_byte(&w, 'i') < 0 ||
        wb_zigzag(&w, version) < 0) {
        PyMem_Free(items.buf);
        PyMem_Free(w.buf);
        return NULL;
    }
    PyMem_Free(items.buf);
    PyObject *out = PyBytes_FromStringAndSize((const char *)w.buf, w.len);
    PyMem_Free(w.buf);
    return out;
}

/* resolve_selector(key, or_equal, offset, version) -> resolved key bytes.
 * Matches storage.py semantics exactly: forward selectors scan
 * [key(+\x00), \xff*32) for the (offset)th live key, else b"\xff\xff";
 * backward selectors scan (b"", key(+\x00)] downward, else b"". */
struct vs_sel_ctx {
    Py_ssize_t skip; /* live keys still to pass over */
    PyObject *found;
};

static int vs_emit_sel(void *ctxp, PyObject *key, PyObject *val) {
    struct vs_sel_ctx *ctx = (struct vs_sel_ctx *)ctxp;
    (void)val;
    if (ctx->skip == 0)
        ctx->found = key; /* borrowed; limit stops the scan right after */
    else
        ctx->skip--;
    return 0;
}

static PyObject *vs_selector_core(VStore *self, PyObject *key, int or_equal,
                                  Py_ssize_t offset, int64_t version) {
    /* or_equal shifts the boundary just past `key` */
    PyObject *edge;
    if (or_equal) {
        Py_ssize_t klen = PyBytes_GET_SIZE(key);
        edge = PyBytes_FromStringAndSize(NULL, klen + 1);
        if (!edge)
            return NULL;
        memcpy(PyBytes_AS_STRING(edge), PyBytes_AS_STRING(key), klen);
        PyBytes_AS_STRING(edge)[klen] = '\0';
    } else {
        edge = Py_NewRef(key);
    }
    struct vs_sel_ctx ctx;
    int more = 0;
    int rc;
    if (offset >= 1) {
        ctx.skip = offset - 1;
        ctx.found = NULL;
        rc = vs_scan(self, edge, g_hi32, version, ctx.skip + 1, 0, 0,
                     vs_emit_sel, &ctx, &more);
    } else {
        ctx.skip = -offset;
        ctx.found = NULL;
        rc = vs_scan(self, g_sel_begin, edge, version, ctx.skip + 1, 0, 1,
                     vs_emit_sel, &ctx, &more);
    }
    Py_DECREF(edge);
    if (rc < 0)
        return NULL;
    if (ctx.found)
        return Py_NewRef(ctx.found);
    return Py_NewRef(offset >= 1 ? g_sel_end : g_sel_begin);
}

static PyObject *vs_resolve_selector(VStore *self, PyObject *args) {
    PyObject *key;
    int or_equal;
    Py_ssize_t offset;
    long long version;
    if (!PyArg_ParseTuple(args, "SpnL", &key, &or_equal, &offset, &version))
        return NULL;
    return vs_selector_core(self, key, or_equal, offset, version);
}

/* -- window maintenance -- */

static PyObject *vs_forget_before(VStore *self, PyObject *arg) {
    long long version = PyLong_AsLongLong(arg);
    if (version == -1 && PyErr_Occurred())
        return NULL;
    PyObject *dead = PyList_New(0);
    if (!dead)
        return NULL;
    for (VSNode *x = self->head->ln[0].next; x; x = x->ln[0].next) {
        VChain *c = &x->ch;
        Py_ssize_t i = chain_bisect(c, version);
        if (i > 0) { /* keep the newest entry at-or-before `version` */
            for (Py_ssize_t j = 0; j < i; j++) {
                self->bytes -= vs_val_bytes(c->values[j]);
                Py_DECREF(c->values[j]);
            }
            memmove(c->versions, c->versions + i,
                    (c->n - i) * sizeof(int64_t));
            memmove(c->values, c->values + i,
                    (c->n - i) * sizeof(PyObject *));
            c->n -= i;
        }
        if (c->n == 1 && c->values[0] == Py_None) {
            if (PyList_Append(dead, x->key) < 0) {
                Py_DECREF(dead);
                return NULL;
            }
        }
    }
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(dead); i++)
        vs_discard(self, PyList_GET_ITEM(dead, i));
    Py_DECREF(dead);
    Py_RETURN_NONE;
}

static PyObject *vs_rollback(VStore *self, PyObject *arg) {
    long long version = PyLong_AsLongLong(arg);
    if (version == -1 && PyErr_Occurred())
        return NULL;
    PyObject *dead = PyList_New(0);
    if (!dead)
        return NULL;
    for (VSNode *x = self->head->ln[0].next; x; x = x->ln[0].next) {
        VChain *c = &x->ch;
        Py_ssize_t keep = chain_bisect(c, version) + 1; /* entries <= version */
        if (keep < c->n) {
            for (Py_ssize_t j = keep; j < c->n; j++) {
                self->bytes -= vs_val_bytes(c->values[j]);
                Py_DECREF(c->values[j]);
            }
            c->n = keep;
        }
        if (c->n == 0) {
            if (PyList_Append(dead, x->key) < 0) {
                Py_DECREF(dead);
                return NULL;
            }
        }
    }
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(dead); i++)
        vs_discard(self, PyList_GET_ITEM(dead, i));
    Py_DECREF(dead);
    Py_RETURN_NONE;
}

static PyObject *vs_byte_size(VStore *self, PyObject *noargs) {
    (void)noargs;
    return PyLong_FromLongLong(self->bytes);
}

static Py_ssize_t vs_len(VStore *self) { return self->n; }

/* -- type boilerplate -- */

static PyObject *vstore_new(PyTypeObject *type, PyObject *args,
                            PyObject *kwds) {
    (void)args;
    (void)kwds;
    VStore *self = (VStore *)type->tp_alloc(type, 0);
    if (!self)
        return NULL;
    self->head = vs_node_new(NULL, OM_MAX_LEVEL);
    if (!self->head) {
        Py_DECREF(self);
        return PyErr_NoMemory();
    }
    self->cur_level = 1;
    self->n = 0;
    self->bytes = 0;
    self->rng = 0x9E3779B97F4A7C15ULL;
    return (PyObject *)self;
}

static void vstore_dealloc(VStore *self) {
    if (self->head) {
        VSNode *x = self->head->ln[0].next;
        while (x) {
            VSNode *nx = x->ln[0].next;
            vs_node_free(x);
            x = nx;
        }
        vs_node_free(self->head);
    }
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef vs_methods[] = {
    {"put", (PyCFunction)vs_put, METH_VARARGS,
     "put(key, version, value_or_None)"},
    {"latest", (PyCFunction)vs_latest, METH_O,
     "latest(key) -> newest value (None if absent/cleared)"},
    {"clear_range", (PyCFunction)vs_clear_range, METH_VARARGS,
     "clear_range(begin, end, version): tombstone live keys in [begin, end)"},
    {"get", (PyCFunction)vs_get, METH_VARARGS,
     "get(key, version) -> value at version (None if absent/cleared)"},
    {"get_many", (PyCFunction)vs_get_many, METH_VARARGS,
     "get_many(reads, oldest) -> [(0, value) | (1, 'transaction_too_old')]"},
    {"get_many_encode", (PyCFunction)vs_get_many_encode, METH_VARARGS,
     "get_many_encode(reads, oldest, tid) -> GetValuesReply wire frame"},
    {"range_read", (PyCFunction)vs_range_read, METH_VARARGS,
     "range_read(begin, end, version, limit=0, limit_bytes=0, reverse=False)"
     " -> (pairs, more)"},
    {"range_read_encode", (PyCFunction)vs_range_read_encode, METH_VARARGS,
     "range_read_encode(begin, end, version, limit, limit_bytes, reverse,"
     " tid) -> GetKeyValuesReply wire frame"},
    {"resolve_selector", (PyCFunction)vs_resolve_selector, METH_VARARGS,
     "resolve_selector(key, or_equal, offset, version) -> resolved key"},
    {"forget_before", (PyCFunction)vs_forget_before, METH_O,
     "forget_before(version): trim chain prefixes outside the MVCC window"},
    {"rollback", (PyCFunction)vs_rollback, METH_O,
     "rollback(version): drop entries newer than version"},
    {"byte_size", (PyCFunction)vs_byte_size, METH_NOARGS,
     "byte_size() -> bookkeeping bytes (matches VersionedMap.byte_size)"},
    {NULL, NULL, 0, NULL}};

static PySequenceMethods vs_as_sequence = {
    .sq_length = (lenfunc)vs_len,
};

static PyTypeObject VStoreType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "fdb_native.VStore",
    .tp_basicsize = sizeof(VStore),
    .tp_dealloc = (destructor)vstore_dealloc,
    .tp_as_sequence = &vs_as_sequence,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "MVCC versioned key store (storage server read path)",
    .tp_methods = vs_methods,
    .tp_new = vstore_new,
};

/* ------------------------------------------------------------------ */
/* Redwood native read path                                            */
/* ------------------------------------------------------------------ */

/* A RedwoodRun handle owns one immutable run image (the bytes object is
 * kept alive for the handle's lifetime, so value reads are zero-copy
 * extents into it), a parsed run index, the optional bloom section, the
 * run's range tombstones, and a bounded FIFO block cache with the same
 * semantics as the Python dict cache in storage/redwood.py (_block):
 * decode on miss, evict the oldest insertion, never reorder on hit. */

#define REDWOOD_RUN_MAGIC 0x5EDB4513u
#define REDWOOD_RUN_FORMAT_VERSION 2u
#define REDWOOD_BLOOM_MAGIC 0x5EDBB1F1u
#define REDWOOD_BLOOM_SALT 0xB1u

/* Python bytes ordering: lexicographic, shorter string sorts first on tie */
static int rw_bytes_cmp(const uint8_t *a, Py_ssize_t alen,
                        const uint8_t *b, Py_ssize_t blen) {
    Py_ssize_t n = alen < blen ? alen : blen;
    int c = n ? memcmp(a, b, n) : 0;
    if (c)
        return c;
    return (alen > blen) - (alen < blen);
}

/* Double hashing over CRC-32C: h1 = crc32c(key), h2 = crc32c(key + salt).
 * Extending h1 by the salt byte equals hashing the concatenation, so the
 * Python fallback (crc32c(key + b"\xb1")) lands on the same h2. */
static void rw_bloom_hashes(const uint8_t *key, Py_ssize_t klen,
                            uint32_t *h1, uint32_t *h2) {
    uint8_t salt = REDWOOD_BLOOM_SALT;
    *h1 = crc32c_sw(0, key, klen);
    *h2 = crc32c_sw(*h1, &salt, 1);
}

static int rw_bloom_maybe(const uint8_t *bits, uint64_t n_bits,
                          uint32_t n_hashes, const uint8_t *key,
                          Py_ssize_t klen) {
    uint32_t h1, h2;
    rw_bloom_hashes(key, klen, &h1, &h2);
    for (uint32_t i = 0; i < n_hashes; i++) {
        uint64_t bit = ((uint64_t)h1 + (uint64_t)i * h2) % n_bits;
        if (!(bits[bit >> 3] & (1u << (bit & 7))))
            return 0;
    }
    return 1;
}

/* Validate a bloom section (header + filter bytes); -1 without PyErr. */
static int rw_bloom_parse(const uint8_t *sec, Py_ssize_t seclen,
                          uint32_t *n_hashes, uint64_t *n_bits) {
    if (seclen < 24)
        return -1;
    uint32_t magic, nh;
    uint64_t nb;
    memcpy(&magic, sec, 4);
    memcpy(&nh, sec + 4, 4);
    memcpy(&nb, sec + 8, 8);
    if (magic != REDWOOD_BLOOM_MAGIC || nb == 0 || nh < 1 || nh > 64)
        return -1;
    if ((uint64_t)(seclen - 24) != (nb + 7) / 8)
        return -1;
    *n_hashes = nh;
    *n_bits = nb;
    return 0;
}

static PyObject *py_redwood_bloom_build(PyObject *self, PyObject *args) {
    PyObject *keys;
    long bits_per_key, n_hashes;
    if (!PyArg_ParseTuple(args, "Oll", &keys, &bits_per_key, &n_hashes))
        return NULL;
    if (bits_per_key < 1 || n_hashes < 1 || n_hashes > 64) {
        PyErr_SetString(PyExc_ValueError, "bad bloom parameters");
        return NULL;
    }
    PyObject *seq = PySequence_Fast(keys, "keys must be a sequence");
    if (!seq)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    uint64_t n_bits = (uint64_t)n * (uint64_t)bits_per_key;
    if (n_bits < 64)
        n_bits = 64;
    Py_ssize_t nbytes = (Py_ssize_t)((n_bits + 7) / 8);
    PyObject *out = PyBytes_FromStringAndSize(NULL, 24 + nbytes);
    if (!out) {
        Py_DECREF(seq);
        return NULL;
    }
    uint8_t *o = (uint8_t *)PyBytes_AS_STRING(out);
    uint32_t magic = REDWOOD_BLOOM_MAGIC, nh32 = (uint32_t)n_hashes;
    uint64_t nk = (uint64_t)n;
    memcpy(o, &magic, 4);
    memcpy(o + 4, &nh32, 4);
    memcpy(o + 8, &n_bits, 8);
    memcpy(o + 16, &nk, 8);
    uint8_t *bits = o + 24;
    memset(bits, 0, nbytes);
    for (Py_ssize_t i = 0; i < n; i++) {
        char *k;
        Py_ssize_t klen;
        if (PyBytes_AsStringAndSize(PySequence_Fast_GET_ITEM(seq, i),
                                    &k, &klen) < 0) {
            Py_DECREF(seq);
            Py_DECREF(out);
            return NULL;
        }
        uint32_t h1, h2;
        rw_bloom_hashes((const uint8_t *)k, klen, &h1, &h2);
        for (uint32_t j = 0; j < nh32; j++) {
            uint64_t bit = ((uint64_t)h1 + (uint64_t)j * h2) % n_bits;
            bits[bit >> 3] |= (uint8_t)(1u << (bit & 7));
        }
    }
    Py_DECREF(seq);
    return out;
}

static PyObject *py_redwood_bloom_query(PyObject *self, PyObject *args) {
    Py_buffer sec, key;
    if (!PyArg_ParseTuple(args, "y*y*", &sec, &key))
        return NULL;
    uint32_t nh;
    uint64_t nb;
    if (rw_bloom_parse((const uint8_t *)sec.buf, sec.len, &nh, &nb) < 0) {
        PyBuffer_Release(&sec);
        PyBuffer_Release(&key);
        PyErr_SetString(PyExc_ValueError, "corrupt redwood bloom section");
        return NULL;
    }
    int maybe = rw_bloom_maybe((const uint8_t *)sec.buf + 24, nb, nh,
                               (const uint8_t *)key.buf, key.len);
    PyBuffer_Release(&sec);
    PyBuffer_Release(&key);
    return PyBool_FromLong(maybe);
}

/* One decoded block resident in the cache: keys are materialized (prefix
 * decompression), values stay as extents into the run image. */
typedef struct {
    int32_t block;    /* block index resident here, or -1 */
    uint32_t n;       /* entries */
    uint8_t *keys;    /* concatenated full keys */
    size_t *key_off;  /* offsets into keys */
    uint32_t *key_len;
    Py_ssize_t *val_off; /* absolute offsets into the run image */
    uint32_t *val_len;
} RWCacheSlot;

typedef struct {
    PyObject_HEAD
    PyObject *image;  /* owned bytes: the whole run file */
    PyObject *clears; /* owned PySequence_Fast of (begin, end) tuples */
    const uint8_t *buf;
    Py_ssize_t blen;
    uint32_t n_blocks;
    Py_ssize_t *blk_off; /* absolute block offsets in the image */
    uint32_t *blk_len;
    Py_ssize_t *lk_off; /* per-block last-key extents (into the image) */
    uint32_t *lk_len;
    const uint8_t *bloom_bits; /* NULL when the run carries no bloom */
    uint64_t bloom_nbits;
    uint32_t bloom_hashes;
    const uint8_t **cl_bp; /* clear-range begin/end extents (borrowed via */
    Py_ssize_t *cl_bl;     /* the owned clears sequence above) */
    const uint8_t **cl_ep;
    Py_ssize_t *cl_el;
    Py_ssize_t n_clears;
    RWCacheSlot *slots; /* FIFO ring: fill, then evict at hand */
    int32_t *slot_of;   /* n_blocks entries: slot index or -1 */
    uint32_t cache_cap;
    uint32_t hand;
    int closed;
    uint64_t hits, misses, bloom_neg, blocks_decoded;
} RedwoodRun;

static PyTypeObject RedwoodRunType;

static void rr_slot_clear(RWCacheSlot *s) {
    PyMem_Free(s->keys);
    PyMem_Free(s->key_off);
    PyMem_Free(s->key_len);
    PyMem_Free(s->val_off);
    PyMem_Free(s->val_len);
    memset(s, 0, sizeof(*s));
    s->block = -1;
}

static void rr_drop(RedwoodRun *self) {
    if (self->slots) {
        for (uint32_t i = 0; i < self->cache_cap; i++)
            rr_slot_clear(&self->slots[i]);
        PyMem_Free(self->slots);
        self->slots = NULL;
    }
    PyMem_Free(self->slot_of);
    PyMem_Free(self->blk_off);
    PyMem_Free(self->blk_len);
    PyMem_Free(self->lk_off);
    PyMem_Free(self->lk_len);
    PyMem_Free(self->cl_bp);
    PyMem_Free(self->cl_bl);
    PyMem_Free(self->cl_ep);
    PyMem_Free(self->cl_el);
    self->slot_of = NULL;
    self->blk_off = NULL;
    self->blk_len = NULL;
    self->lk_off = NULL;
    self->lk_len = NULL;
    self->cl_bp = NULL;
    self->cl_bl = NULL;
    self->cl_ep = NULL;
    self->cl_el = NULL;
    self->n_clears = 0;
    self->n_blocks = 0;
    self->bloom_bits = NULL;
    self->buf = NULL;
    self->blen = 0;
    Py_CLEAR(self->image);
    Py_CLEAR(self->clears);
    self->closed = 1;
}

/* Decode block `bi` into slot `s` (same validation order as the block
 * codec above and the Python fallback). 0 on success, -1 with PyErr. */
static int rr_decode_into(RedwoodRun *self, uint32_t bi, RWCacheSlot *s) {
    const uint8_t *b = self->buf + self->blk_off[bi];
    Py_ssize_t bl = self->blk_len[bi];
    uint32_t magic, n, plen, crc;
    if (bl < 16)
        goto corrupt;
    memcpy(&magic, b, 4);
    memcpy(&n, b + 4, 4);
    memcpy(&plen, b + 8, 4);
    memcpy(&crc, b + 12, 4);
    if (magic != REDWOOD_BLOCK_MAGIC || (Py_ssize_t)plen != bl - 16 ||
        crc32c_sw(0, b + 16, plen) != crc)
        goto corrupt;
    /* every entry costs at least its 8-byte header: reject a corrupt count
     * before it sizes the slot arrays */
    if (n > plen / 8)
        goto corrupt;
    size_t *ko = PyMem_Malloc(((size_t)n + 1) * sizeof(size_t));
    if (!ko)
        goto nomem;
    s->key_off = ko;
    uint32_t *kl = PyMem_Malloc(((size_t)n + 1) * 4);
    if (!kl)
        goto nomem;
    s->key_len = kl;
    Py_ssize_t *vo = PyMem_Malloc(((size_t)n + 1) * sizeof(Py_ssize_t));
    if (!vo)
        goto nomem;
    s->val_off = vo;
    uint32_t *vl = PyMem_Malloc(((size_t)n + 1) * 4);
    if (!vl)
        goto nomem;
    s->val_len = vl;
    /* prefix re-expansion can exceed the payload size; grow on demand */
    size_t kcap = (size_t)plen + 16;
    uint8_t *kb = PyMem_Malloc(kcap);
    if (!kb)
        goto nomem;
    s->keys = kb;
    {
        const uint8_t *p = b + 16, *end = b + 16 + plen;
        size_t koff = 0;
        size_t prev_off = 0;
        uint32_t prev_len = 0;
        int have_prev = 0;
        for (uint32_t i = 0; i < n; i++) {
            uint16_t shared, slen;
            uint32_t vlen;
            if (end - p < 8)
                goto corrupt;
            memcpy(&shared, p, 2);
            memcpy(&slen, p + 2, 2);
            memcpy(&vlen, p + 4, 4);
            p += 8;
            if ((Py_ssize_t)(end - p) < (Py_ssize_t)slen + (Py_ssize_t)vlen ||
                (!have_prev && shared != 0) ||
                (have_prev && shared > prev_len))
                goto corrupt;
            size_t klen = (size_t)shared + slen;
            if (koff + klen > kcap) {
                size_t ncap = kcap * 2;
                while (ncap < koff + klen)
                    ncap *= 2;
                uint8_t *nk = PyMem_Realloc(s->keys, ncap);
                if (!nk)
                    goto nomem;
                s->keys = nk;
                kcap = ncap;
            }
            if (shared)
                memmove(s->keys + koff, s->keys + prev_off, shared);
            memcpy(s->keys + koff + shared, p, slen);
            p += slen;
            s->key_off[i] = koff;
            s->key_len[i] = (uint32_t)klen;
            s->val_off[i] = p - self->buf;
            s->val_len[i] = vlen;
            p += vlen;
            prev_off = koff;
            prev_len = (uint32_t)klen;
            have_prev = 1;
            koff += klen;
        }
        if (p != end)
            goto corrupt;
    }
    s->n = n;
    s->block = (int32_t)bi;
    return 0;
corrupt:
    PyErr_SetString(PyExc_ValueError, "corrupt redwood block");
    return -1;
nomem:
    PyErr_NoMemory();
    return -1;
}

/* Cache lookup for block `bi`: FIFO ring, decode on miss. NULL on error
 * (slot left empty, PyErr set). */
static RWCacheSlot *rr_block(RedwoodRun *self, uint32_t bi) {
    int32_t si = self->slot_of[bi];
    if (si >= 0) {
        self->hits++;
        return &self->slots[si];
    }
    self->misses++;
    self->blocks_decoded++;
    uint32_t slot = self->hand;
    RWCacheSlot *s = &self->slots[slot];
    if (s->block >= 0)
        self->slot_of[s->block] = -1;
    rr_slot_clear(s);
    if (rr_decode_into(self, bi, s) < 0) {
        rr_slot_clear(s);
        return NULL;
    }
    self->slot_of[bi] = (int32_t)slot;
    self->hand = (slot + 1) % self->cache_cap;
    return s;
}

static int rr_cleared(RedwoodRun *self, const uint8_t *key, Py_ssize_t klen) {
    for (Py_ssize_t i = 0; i < self->n_clears; i++) {
        if (rw_bytes_cmp(self->cl_bp[i], self->cl_bl[i], key, klen) <= 0 &&
            rw_bytes_cmp(key, klen, self->cl_ep[i], self->cl_el[i]) < 0)
            return 1;
    }
    return 0;
}

/* index of the first block whose last_key >= key (== n_blocks when every
 * block ends before key) — _Run.first_block_for */
static int64_t rr_first_block_for(RedwoodRun *self, const uint8_t *key,
                                  Py_ssize_t klen) {
    int64_t lo = 0, hi = self->n_blocks;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (rw_bytes_cmp(self->buf + self->lk_off[mid], self->lk_len[mid],
                         key, klen) < 0)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

/* Point lookup within one run. 1 = found (voff/vlen set; an in-run entry
 * beats the run's own clears, matching the Python read order), 2 = shadowed
 * by this run's clears, 0 = miss, -1 = error with PyErr set. */
static int rr_find(RedwoodRun *self, const uint8_t *key, Py_ssize_t klen,
                   Py_ssize_t *voff, uint32_t *vlen) {
    if (self->closed) {
        PyErr_SetString(PyExc_ValueError, "redwood run handle is closed");
        return -1;
    }
    if (self->bloom_bits &&
        !rw_bloom_maybe(self->bloom_bits, self->bloom_nbits,
                        self->bloom_hashes, key, klen)) {
        self->bloom_neg++;
        return rr_cleared(self, key, klen) ? 2 : 0;
    }
    int64_t bi = rr_first_block_for(self, key, klen);
    if (bi < (int64_t)self->n_blocks) {
        RWCacheSlot *s = rr_block(self, (uint32_t)bi);
        if (!s)
            return -1;
        int64_t lo = 0, hi = s->n;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (rw_bytes_cmp(s->keys + s->key_off[mid], s->key_len[mid],
                             key, klen) < 0)
                lo = mid + 1;
            else
                hi = mid;
        }
        if (lo < (int64_t)s->n && s->key_len[lo] == (uint64_t)klen &&
            memcmp(s->keys + s->key_off[lo], key, klen) == 0) {
            *voff = s->val_off[lo];
            *vlen = s->val_len[lo];
            return 1;
        }
    }
    return rr_cleared(self, key, klen) ? 2 : 0;
}

static PyObject *rr_get(RedwoodRun *self, PyObject *arg) {
    char *k;
    Py_ssize_t klen;
    if (PyBytes_AsStringAndSize(arg, &k, &klen) < 0)
        return NULL;
    Py_ssize_t voff = 0;
    uint32_t vlen = 0;
    int st = rr_find(self, (const uint8_t *)k, klen, &voff, &vlen);
    if (st < 0)
        return NULL;
    if (st != 1)
        return Py_BuildValue("(iO)", st, Py_None);
    PyObject *val = PyBytes_FromStringAndSize((const char *)self->buf + voff,
                                              vlen);
    if (!val)
        return NULL;
    return Py_BuildValue("(iN)", 1, val);
}

static PyObject *rr_may_contain(RedwoodRun *self, PyObject *arg) {
    char *k;
    Py_ssize_t klen;
    if (self->closed) {
        PyErr_SetString(PyExc_ValueError, "redwood run handle is closed");
        return NULL;
    }
    if (PyBytes_AsStringAndSize(arg, &k, &klen) < 0)
        return NULL;
    if (!self->bloom_bits)
        Py_RETURN_TRUE;
    return PyBool_FromLong(rw_bloom_maybe(self->bloom_bits, self->bloom_nbits,
                                          self->bloom_hashes,
                                          (const uint8_t *)k, klen));
}

static PyObject *rr_stats(RedwoodRun *self, PyObject *noargs) {
    return Py_BuildValue(
        "{s:K,s:K,s:K,s:K,s:I}",
        "block_cache_hits", (unsigned long long)self->hits,
        "block_cache_misses", (unsigned long long)self->misses,
        "bloom_negatives", (unsigned long long)self->bloom_neg,
        "blocks_decoded", (unsigned long long)self->blocks_decoded,
        "n_blocks", (unsigned int)self->n_blocks);
}

static PyObject *rr_close_method(RedwoodRun *self, PyObject *noargs) {
    rr_drop(self); /* idempotent: everything it frees is NULLed */
    Py_RETURN_NONE;
}

static void rr_dealloc(RedwoodRun *self) {
    rr_drop(self);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef rr_methods[] = {
    {"get", (PyCFunction)rr_get, METH_O,
     "get(key) -> (status, value): 1 found, 0 miss, 2 shadowed by this "
     "run's clear ranges"},
    {"may_contain", (PyCFunction)rr_may_contain, METH_O,
     "may_contain(key) -> bloom verdict (True when the run has no bloom)"},
    {"stats", (PyCFunction)rr_stats, METH_NOARGS,
     "stats() -> dict of block-cache / bloom counters"},
    {"close", (PyCFunction)rr_close_method, METH_NOARGS,
     "close(): release the image and cache (idempotent)"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject RedwoodRunType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "fdb_native.RedwoodRun",
    .tp_basicsize = sizeof(RedwoodRun),
    .tp_dealloc = (destructor)rr_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "immutable redwood run handle (open via redwood_run_open)",
    .tp_methods = rr_methods,
};

/* redwood_run_open(image, clears, cache_blocks) -> RedwoodRun.
 * `image` is a complete v2 run file (RedwoodRunHeader + body); `clears`
 * the run's decoded range tombstones as (begin, end) bytes tuples (the
 * aux region is wire-encoded — Python already decoded it in parse_run, so
 * the wire codec is not re-implemented here). Raises ValueError on
 * anything a Python parse_run would reject. */
static PyObject *py_redwood_run_open(PyObject *self, PyObject *args) {
    PyObject *image, *clears;
    long cache_blocks;
    if (!PyArg_ParseTuple(args, "SOl", &image, &clears, &cache_blocks))
        return NULL;
    const uint8_t *buf = (const uint8_t *)PyBytes_AS_STRING(image);
    Py_ssize_t blen = PyBytes_GET_SIZE(image);
    uint32_t magic, ver, n_blocks, n_sources, index_bytes, aux_bytes,
        bloom_bytes, body_crc;
    if (blen < 52)
        goto corrupt;
    memcpy(&magic, buf, 4);
    memcpy(&ver, buf + 4, 4);
    memcpy(&n_blocks, buf + 28, 4);
    memcpy(&n_sources, buf + 32, 4);
    memcpy(&index_bytes, buf + 36, 4);
    memcpy(&aux_bytes, buf + 40, 4);
    memcpy(&bloom_bytes, buf + 44, 4);
    memcpy(&body_crc, buf + 48, 4);
    if (magic != REDWOOD_RUN_MAGIC || ver != REDWOOD_RUN_FORMAT_VERSION)
        goto corrupt;
    uint64_t fixed = (uint64_t)n_sources * 8 + (uint64_t)index_bytes +
                     (uint64_t)aux_bytes + (uint64_t)bloom_bytes;
    if (fixed > (uint64_t)(blen - 52))
        goto corrupt;
    /* every index entry costs at least its 10 fixed bytes: reject a corrupt
     * block count before it sizes the index arrays */
    if (n_blocks > index_bytes / 10)
        goto corrupt;
    {
        uint32_t crc;
        Py_BEGIN_ALLOW_THREADS
        crc = crc32c_sw(0, buf + 52, blen - 52);
        Py_END_ALLOW_THREADS
        if (crc != body_crc)
            goto corrupt;
    }
    RedwoodRun *run = (RedwoodRun *)RedwoodRunType.tp_alloc(&RedwoodRunType,
                                                            0);
    if (!run)
        return NULL;
    Py_INCREF(image);
    run->image = image;
    run->buf = buf;
    run->blen = blen;
    run->n_blocks = n_blocks;
    {
        uint32_t cap = cache_blocks < 1 ? 1 : (uint32_t)cache_blocks;
        if (n_blocks && cap > n_blocks)
            cap = n_blocks;
        run->cache_cap = cap;
    }
    Py_ssize_t *po = PyMem_Malloc(((size_t)n_blocks + 1) * sizeof(Py_ssize_t));
    if (!po)
        goto nomem;
    run->blk_off = po;
    uint32_t *pl = PyMem_Malloc(((size_t)n_blocks + 1) * 4);
    if (!pl)
        goto nomem;
    run->blk_len = pl;
    Py_ssize_t *lo = PyMem_Malloc(((size_t)n_blocks + 1) * sizeof(Py_ssize_t));
    if (!lo)
        goto nomem;
    run->lk_off = lo;
    uint32_t *ll = PyMem_Malloc(((size_t)n_blocks + 1) * 4);
    if (!ll)
        goto nomem;
    run->lk_len = ll;
    int32_t *so = PyMem_Malloc(((size_t)n_blocks + 1) * sizeof(int32_t));
    if (!so)
        goto nomem;
    run->slot_of = so;
    for (uint32_t i = 0; i < n_blocks; i++)
        run->slot_of[i] = -1;
    RWCacheSlot *slots = PyMem_Malloc((size_t)run->cache_cap *
                                      sizeof(RWCacheSlot));
    if (!slots)
        goto nomem;
    memset(slots, 0, (size_t)run->cache_cap * sizeof(RWCacheSlot));
    for (uint32_t i = 0; i < run->cache_cap; i++)
        slots[i].block = -1;
    run->slots = slots;
    {
        const uint8_t *ip = buf + 52 + (size_t)n_sources * 8;
        const uint8_t *iend = ip + index_bytes;
        Py_ssize_t blocks_off = 52 + (Py_ssize_t)fixed;
        Py_ssize_t blocks_len = blen - blocks_off;
        for (uint32_t i = 0; i < n_blocks; i++) {
            uint32_t boff, bl32;
            uint16_t kl16;
            if (iend - ip < 10)
                goto corrupt_run;
            memcpy(&boff, ip, 4);
            memcpy(&bl32, ip + 4, 4);
            memcpy(&kl16, ip + 8, 2);
            ip += 10;
            if (iend - ip < (Py_ssize_t)kl16)
                goto corrupt_run;
            run->lk_off[i] = ip - buf;
            run->lk_len[i] = kl16;
            ip += kl16;
            if ((uint64_t)boff + bl32 > (uint64_t)blocks_len)
                goto corrupt_run;
            run->blk_off[i] = blocks_off + (Py_ssize_t)boff;
            run->blk_len[i] = bl32;
        }
        if (ip != iend)
            goto corrupt_run;
        if (bloom_bytes) {
            const uint8_t *bsec = buf + 52 + (size_t)n_sources * 8 +
                                  index_bytes + aux_bytes;
            if (rw_bloom_parse(bsec, (Py_ssize_t)bloom_bytes,
                               &run->bloom_hashes, &run->bloom_nbits) < 0)
                goto corrupt_run;
            run->bloom_bits = bsec + 24;
        }
    }
    {
        PyObject *seq = PySequence_Fast(clears, "clears must be a sequence");
        if (!seq)
            goto fail;
        run->clears = seq; /* the handle owns it from here on */
        Py_ssize_t ncl = PySequence_Fast_GET_SIZE(seq);
        const uint8_t **bp = PyMem_Malloc(((size_t)ncl + 1) * sizeof(void *));
        if (!bp)
            goto nomem;
        run->cl_bp = bp;
        Py_ssize_t *blens = PyMem_Malloc(((size_t)ncl + 1) *
                                         sizeof(Py_ssize_t));
        if (!blens)
            goto nomem;
        run->cl_bl = blens;
        const uint8_t **ep = PyMem_Malloc(((size_t)ncl + 1) * sizeof(void *));
        if (!ep)
            goto nomem;
        run->cl_ep = ep;
        Py_ssize_t *elens = PyMem_Malloc(((size_t)ncl + 1) *
                                         sizeof(Py_ssize_t));
        if (!elens)
            goto nomem;
        run->cl_el = elens;
        for (Py_ssize_t i = 0; i < ncl; i++) {
            /* tuples only: a list pair could be mutated after open, leaving
             * the cached pointers dangling */
            PyObject *pair = PySequence_Fast_GET_ITEM(seq, i);
            if (!PyTuple_CheckExact(pair) || PyTuple_GET_SIZE(pair) != 2) {
                PyErr_SetString(PyExc_TypeError,
                                "clears must be (begin, end) bytes tuples");
                goto fail;
            }
            char *cb, *ce;
            Py_ssize_t cbl, cel;
            if (PyBytes_AsStringAndSize(PyTuple_GET_ITEM(pair, 0),
                                        &cb, &cbl) < 0 ||
                PyBytes_AsStringAndSize(PyTuple_GET_ITEM(pair, 1),
                                        &ce, &cel) < 0)
                goto fail;
            run->cl_bp[i] = (const uint8_t *)cb;
            run->cl_bl[i] = cbl;
            run->cl_ep[i] = (const uint8_t *)ce;
            run->cl_el[i] = cel;
            run->n_clears = i + 1;
        }
    }
    return (PyObject *)run;
corrupt:
    PyErr_SetString(PyExc_ValueError, "corrupt redwood run");
    return NULL;
corrupt_run:
    Py_DECREF(run);
    PyErr_SetString(PyExc_ValueError, "corrupt redwood run");
    return NULL;
nomem:
    Py_DECREF(run);
    return PyErr_NoMemory();
fail:
    Py_DECREF(run);
    return NULL;
}

/* validate every element is an open RedwoodRun handle */
static int rw_check_runs(PyObject *seq, Py_ssize_t n) {
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *o = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyObject_TypeCheck(o, &RedwoodRunType)) {
            PyErr_SetString(PyExc_TypeError,
                            "runs must be RedwoodRun handles");
            return -1;
        }
        if (((RedwoodRun *)o)->closed) {
            PyErr_SetString(PyExc_ValueError,
                            "redwood run handle is closed");
            return -1;
        }
    }
    return 0;
}

/* newest-source-wins cascade over run handles: 1 found (extent returned),
 * 0 miss or shadowed by a clear, -1 error. `runs` has been validated by
 * rw_check_runs and `n_runs` is its PySequence_Fast_GET_SIZE bound. */
static int rw_cascade(PyObject *runs, Py_ssize_t n_runs, const uint8_t *key,
                      Py_ssize_t klen, RedwoodRun **vrun, Py_ssize_t *voff,
                      uint32_t *vlen) {
    for (Py_ssize_t i = 0; i < n_runs; i++) {
        RedwoodRun *r = (RedwoodRun *)PySequence_Fast_GET_ITEM(runs, i);
        int st = rr_find(r, key, klen, voff, vlen);
        if (st < 0)
            return -1;
        if (st == 1) {
            *vrun = r;
            return 1;
        }
        if (st == 2)
            return 0;
    }
    return 0;
}

/* redwood_runs_get(runs, key) -> value bytes | None */
static PyObject *py_redwood_runs_get(PyObject *self, PyObject *args) {
    PyObject *runs, *keyobj;
    if (!PyArg_ParseTuple(args, "OS", &runs, &keyobj))
        return NULL;
    PyObject *seq = PySequence_Fast(runs, "runs must be a sequence");
    if (!seq)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (rw_check_runs(seq, n) < 0) {
        Py_DECREF(seq);
        return NULL;
    }
    RedwoodRun *vr = NULL;
    Py_ssize_t voff = 0;
    uint32_t vlen = 0;
    int st = rw_cascade(seq, n, (const uint8_t *)PyBytes_AS_STRING(keyobj),
                        PyBytes_GET_SIZE(keyobj), &vr, &voff, &vlen);
    Py_DECREF(seq);
    if (st < 0)
        return NULL;
    if (st == 0)
        Py_RETURN_NONE;
    return PyBytes_FromStringAndSize((const char *)vr->buf + voff, vlen);
}

/* redwood_runs_get_batch(runs, keys) -> [value | None, ...] — one Python
 * boundary crossing for the whole batch */
static PyObject *py_redwood_runs_get_batch(PyObject *self, PyObject *args) {
    PyObject *runs, *keys;
    if (!PyArg_ParseTuple(args, "OO", &runs, &keys))
        return NULL;
    PyObject *rseq = PySequence_Fast(runs, "runs must be a sequence");
    if (!rseq)
        return NULL;
    Py_ssize_t nr = PySequence_Fast_GET_SIZE(rseq);
    if (rw_check_runs(rseq, nr) < 0) {
        Py_DECREF(rseq);
        return NULL;
    }
    PyObject *kseq = PySequence_Fast(keys, "keys must be a sequence");
    if (!kseq) {
        Py_DECREF(rseq);
        return NULL;
    }
    Py_ssize_t nk = PySequence_Fast_GET_SIZE(kseq);
    PyObject *out = PyList_New(nk);
    if (!out)
        goto fail;
    for (Py_ssize_t i = 0; i < nk; i++) {
        PyObject *kb = PySequence_Fast_GET_ITEM(kseq, i);
        if (!PyBytes_Check(kb)) {
            PyErr_SetString(PyExc_TypeError, "keys must be bytes");
            goto fail;
        }
        RedwoodRun *vr = NULL;
        Py_ssize_t voff = 0;
        uint32_t vlen = 0;
        int st = rw_cascade(rseq, nr, (const uint8_t *)PyBytes_AS_STRING(kb),
                            PyBytes_GET_SIZE(kb), &vr, &voff, &vlen);
        if (st < 0)
            goto fail;
        PyObject *val;
        if (st == 0) {
            val = Py_NewRef(Py_None);
        } else {
            val = PyBytes_FromStringAndSize((const char *)vr->buf + voff,
                                            vlen);
            if (!val)
                goto fail;
        }
        PyList_SET_ITEM(out, i, val);
    }
    Py_DECREF(kseq);
    Py_DECREF(rseq);
    return out;
fail:
    Py_XDECREF(out);
    Py_DECREF(kseq);
    Py_DECREF(rseq);
    return NULL;
}

/* redwood_runs_get_many_encode(runs, reads, oldest, tid, prefilled)
 * -> complete GetValuesReply frame. `reads` are (key, version) pairs;
 * `prefilled` is a same-length list resolving each read against the
 * engine's memtables: bytes / None = already resolved, False = unresolved
 * (cascade through the run handles, copying the value straight from the
 * run image into the frame — the batched zero-copy read path). */
static PyObject *py_redwood_runs_get_many_encode(PyObject *self,
                                                 PyObject *args) {
    PyObject *runs, *reads, *prefilled;
    long long oldest;
    unsigned long long tid;
    if (!PyArg_ParseTuple(args, "OOLKO", &runs, &reads, &oldest, &tid,
                          &prefilled))
        return NULL;
    PyObject *rseq = PySequence_Fast(runs, "runs must be a sequence");
    if (!rseq)
        return NULL;
    Py_ssize_t nr = PySequence_Fast_GET_SIZE(rseq);
    if (rw_check_runs(rseq, nr) < 0) {
        Py_DECREF(rseq);
        return NULL;
    }
    PyObject *dseq = PySequence_Fast(reads, "reads must be a sequence");
    if (!dseq) {
        Py_DECREF(rseq);
        return NULL;
    }
    PyObject *pseq = PySequence_Fast(prefilled,
                                     "prefilled must be a sequence");
    if (!pseq) {
        Py_DECREF(dseq);
        Py_DECREF(rseq);
        return NULL;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(dseq);
    WBuf w = {NULL, 0, 0};
    if (PySequence_Fast_GET_SIZE(pseq) != n) {
        PyErr_SetString(PyExc_ValueError,
                        "prefilled must match reads in length");
        goto fail;
    }
    if (wb_grow(&w, 64 + n * 24) < 0)
        goto fail;
    w.buf[w.len++] = W_MAGIC;
    w.buf[w.len++] = W_VERSION;
    /* GetValuesReply { results: [(0, value|None) | (1, errname)] } */
    if (wb_byte(&w, 'R') < 0 || wb_varint(&w, tid) < 0 ||
        wb_varint(&w, 1) < 0 || wb_byte(&w, 'l') < 0 ||
        wb_varint(&w, (uint64_t)n) < 0)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key;
        int64_t version;
        if (vs_read_item(PySequence_Fast_GET_ITEM(dseq, i), &key,
                         &version) < 0)
            goto fail;
        if (wb_byte(&w, 't') < 0 || wb_varint(&w, 2) < 0)
            goto fail;
        if (version < oldest) {
            size_t elen = strlen(TOO_OLD_NAME);
            if (wb_byte(&w, 'i') < 0 || wb_varint(&w, 2) < 0 || /* int 1 */
                wb_byte(&w, 's') < 0 || wb_varint(&w, elen) < 0 ||
                wb_raw(&w, TOO_OLD_NAME, elen) < 0)
                goto fail;
            continue;
        }
        if (wb_byte(&w, 'i') < 0 || wb_varint(&w, 0) < 0) /* int 0 */
            goto fail;
        PyObject *pf = PySequence_Fast_GET_ITEM(pseq, i);
        if (pf == Py_False) {
            RedwoodRun *vr = NULL;
            Py_ssize_t voff = 0;
            uint32_t vlen = 0;
            int st = rw_cascade(rseq, nr,
                                (const uint8_t *)PyBytes_AS_STRING(key),
                                PyBytes_GET_SIZE(key), &vr, &voff, &vlen);
            if (st < 0)
                goto fail;
            if (st == 0) {
                if (wb_byte(&w, 'N') < 0)
                    goto fail;
            } else {
                if (wb_byte(&w, 'b') < 0 || wb_varint(&w, vlen) < 0 ||
                    wb_raw(&w, vr->buf + voff, vlen) < 0)
                    goto fail;
            }
        } else if (pf == Py_None || PyBytes_Check(pf)) {
            if (wb_bytes_val(&w, pf) < 0)
                goto fail;
        } else {
            PyErr_SetString(PyExc_TypeError,
                            "prefilled entries must be bytes, None, or "
                            "False");
            goto fail;
        }
    }
    Py_DECREF(pseq);
    Py_DECREF(dseq);
    Py_DECREF(rseq);
    PyObject *out = PyBytes_FromStringAndSize((const char *)w.buf, w.len);
    PyMem_Free(w.buf);
    return out;
fail:
    PyMem_Free(w.buf);
    Py_DECREF(pseq);
    Py_DECREF(dseq);
    Py_DECREF(rseq);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* Native transport data plane (net/native_transport.py binding)       */
/*                                                                     */
/* The FlowTransport analogue: framing, checksum, and the fast-path    */
/* request->reply loop live below Python. A frame on the wire is a     */
/* 25-byte big-endian header — length u32 | token u64 | reply_id u64 | */
/* kind u8 | crc u32 — followed by `length` body bytes, with crc =     */
/* CRC-32C over the body (must stay byte-identical to transport.py's   */
/* _HEADER struct ">IQQBI"; the three-way parity fuzz in               */
/* tests/test_native_transport.py is the gate).                        */
/*                                                                     */
/* TransportTable holds the per-transport dispatch config + counters;  */
/* TransportConn buffers one connection's inbound bytes and serves     */
/* read-dominant request tokens (GET_VALUE / GET_VALUES / GET_RANGE /  */
/* GRV) straight out of the C VStore, emitting complete reply frames   */
/* without materializing Python request or reply objects. Anything the */
/* fast path does not recognize — unknown token, version not yet       */
/* durable, odd encoding, non-request kinds — is handed back verbatim  */
/* as a slow-path tuple for the existing Python dispatcher, which      */
/* remains the semantic authority.                                     */
/* ------------------------------------------------------------------ */

#define TP_HEADER_LEN 25
#define TP_MAX_FRAME (64 * 1024 * 1024) /* = transport.py _MAX_FRAME_BYTES */
#define TP_REQUEST 0
#define TP_REPLY 1
#define TP_REPLY_ERROR 2
#define TP_GIL_CRC_MIN (64 * 1024) /* same crossover as py_crc32c above */

/* serve results; -1 with a pending Python exception is the third state */
#define TP_SERVED 1
#define TP_FALL 0

static inline uint32_t tp_load_u32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static inline uint64_t tp_load_u64(const uint8_t *p) {
    return ((uint64_t)tp_load_u32(p) << 32) | (uint64_t)tp_load_u32(p + 4);
}

static inline void tp_store_u32(uint8_t *p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

static inline void tp_store_u64(uint8_t *p, uint64_t v) {
    tp_store_u32(p, (uint32_t)(v >> 32));
    tp_store_u32(p + 4, (uint32_t)v);
}

/* transport_frame(token, reply_id, kind, body) -> framed bytes */
static PyObject *py_transport_frame(PyObject *self, PyObject *args) {
    unsigned long long token, reply_id;
    int kind;
    Py_buffer body;
    if (!PyArg_ParseTuple(args, "KKiy*", &token, &reply_id, &kind, &body))
        return NULL;
    if (body.len > TP_MAX_FRAME) {
        PyBuffer_Release(&body);
        PyErr_SetString(PyExc_ValueError, "frame body over TP_MAX_FRAME");
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, TP_HEADER_LEN + body.len);
    if (!out) {
        PyBuffer_Release(&body);
        return NULL;
    }
    uint32_t crc;
    if (body.len >= TP_GIL_CRC_MIN) {
        Py_BEGIN_ALLOW_THREADS
        crc = crc32c_sw(0, (const uint8_t *)body.buf, body.len);
        Py_END_ALLOW_THREADS
    } else {
        crc = crc32c_sw(0, (const uint8_t *)body.buf, body.len);
    }
    uint8_t *o = (uint8_t *)PyBytes_AS_STRING(out);
    tp_store_u32(o, (uint32_t)body.len);
    tp_store_u64(o + 4, token);
    tp_store_u64(o + 12, reply_id);
    o[20] = (uint8_t)kind;
    tp_store_u32(o + 21, crc);
    memcpy(o + TP_HEADER_LEN, body.buf, body.len);
    PyBuffer_Release(&body);
    return out;
}

/* -- request-body readers: return -1 on any shape mismatch (the caller
 * falls back to the Python decoder — never an error, never a guess) -- */

static int tp_read_varint(const uint8_t *b, Py_ssize_t blen, Py_ssize_t *pos,
                          uint64_t *out) {
    uint64_t r = 0;
    int shift = 0;
    Py_ssize_t p = *pos, end = blen;
    while (p < end && shift < 64) {
        uint8_t c = b[p++];
        r |= (uint64_t)(c & 0x7F) << shift;
        if (!(c & 0x80)) {
            *pos = p;
            *out = r;
            return 0;
        }
        shift += 7;
    }
    return -1;
}

static int tp_read_zigzag(const uint8_t *b, Py_ssize_t blen, Py_ssize_t *pos,
                          int64_t *out) {
    uint64_t u = 0;
    if (tp_read_varint(b, blen, pos, &u) < 0)
        return -1;
    *out = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
    return 0;
}

static int tp_expect(const uint8_t *b, Py_ssize_t blen, Py_ssize_t *pos,
                     uint8_t want) {
    if (*pos >= blen || b[*pos] != want)
        return -1;
    (*pos)++;
    return 0;
}

/* W_MAGIC/W_VERSION preamble plus the 'R' <tid> <field count> head */
static int tp_request_head(const uint8_t *body, Py_ssize_t blen,
                           Py_ssize_t *pos, uint64_t want_tid,
                           uint64_t want_nf) {
    uint64_t tid = 0, nf = 0;
    if (blen < 2 || body[0] != W_MAGIC || body[1] != W_VERSION)
        return -1;
    *pos = 2;
    if (tp_expect(body, blen, pos, 'R') < 0 ||
        tp_read_varint(body, blen, pos, &tid) < 0 || tid != want_tid ||
        tp_read_varint(body, blen, pos, &nf) < 0 || nf != want_nf)
        return -1;
    return 0;
}

/* raw-key point lookup: vs_search without materializing a PyBytes key */
static VSNode *vs_search_raw(VStore *self, const uint8_t *k,
                             Py_ssize_t klen) {
    VSNode *x = self->head;
    for (int l = self->cur_level - 1; l >= 0; l--)
        while (x->ln[l].next &&
               rw_bytes_cmp((const uint8_t *)PyBytes_AS_STRING(
                                x->ln[l].next->key),
                            PyBytes_GET_SIZE(x->ln[l].next->key), k,
                            klen) < 0)
            x = x->ln[l].next;
    VSNode *nx = x->ln[0].next;
    if (nx && rw_bytes_cmp((const uint8_t *)PyBytes_AS_STRING(nx->key),
                           PyBytes_GET_SIZE(nx->key), k, klen) == 0)
        return nx;
    return NULL;
}

typedef struct {
    PyObject_HEAD
    /* counters (cumulative; Python snapshots and folds deltas) */
    uint64_t frames_in, frames_out, bytes_in, bytes_out;
    uint64_t checksum_rejects, slow_falls;
    uint64_t hits_get_value, hits_get_values, hits_get_range, hits_grv;
    /* storage fast path: active while store != NULL (serve-all only —
     * the wrapper disables it the moment shard maps arrive) */
    VStore *store; /* owned */
    uint64_t tok_get_value, tok_get_values, tok_get_range;
    uint64_t tid_gv_req, tid_gv_rep, tid_gvs_req, tid_gvs_rep;
    uint64_t tid_gkv_req, tid_gkv_rep, tid_sel;
    int64_t oldest, latest; /* MVCC window the C side may answer within */
    int64_t default_limit_bytes;
    /* GRV fast path: bounded by an allowance the proxy's pump refreshes
     * so ratekeeper admission stays in charge of long-run rates */
    int grv_on;
    uint64_t tok_grv, tid_grv_req, tid_grv_rep;
    int64_t grv_version, grv_allowance;
} TransportTable;

/* append one complete reply frame for `body` to the connection's out
 * buffer; replies carry token 0, mirroring transport.py _dispatch */
static int tp_emit_frame(TransportTable *t, WBuf *out, uint64_t reply_id,
                         int kind, const uint8_t *body, Py_ssize_t blen) {
    if (blen > TP_MAX_FRAME) {
        PyErr_SetString(PyExc_ValueError, "reply body over TP_MAX_FRAME");
        return -1;
    }
    if (wb_grow(out, TP_HEADER_LEN + blen) < 0)
        return -1;
    uint8_t *p = out->buf + out->len;
    tp_store_u32(p, (uint32_t)blen);
    tp_store_u64(p + 4, 0);
    tp_store_u64(p + 12, reply_id);
    p[20] = (uint8_t)kind;
    tp_store_u32(p + 21, crc32c_sw(0, body, blen));
    memcpy(p + TP_HEADER_LEN, body, blen);
    out->len += TP_HEADER_LEN + blen;
    t->frames_out++;
    t->bytes_out += (uint64_t)(TP_HEADER_LEN + blen);
    return 0;
}

/* kind=_REPLY_ERROR with a bare error-name string body, byte-identical
 * to wire.dumps(name) for the no-detail case transport.py emits */
static int tp_error_reply(TransportTable *t, WBuf *out, uint64_t reply_id,
                          const char *name) {
    uint8_t b[64];
    size_t n = strlen(name);
    if (n > 48) {
        PyErr_SetString(PyExc_ValueError, "error name too long");
        return -1;
    }
    Py_ssize_t len = 0;
    b[len++] = W_MAGIC;
    b[len++] = W_VERSION;
    b[len++] = 's';
    b[len++] = (uint8_t)n; /* short names: single-byte varint */
    memcpy(b + len, name, n);
    len += (Py_ssize_t)n;
    return tp_emit_frame(t, out, reply_id, TP_REPLY_ERROR, b, len);
}

static int tp_serve_get_value(TransportTable *t, uint64_t reply_id,
                              const uint8_t *body, Py_ssize_t blen,
                              WBuf *out) {
    Py_ssize_t pos = 0;
    uint64_t klen = 0;
    int64_t version = 0;
    if (tp_request_head(body, blen, &pos, t->tid_gv_req, 2) < 0 ||
        tp_expect(body, blen, &pos, 'b') < 0 ||
        tp_read_varint(body, blen, &pos, &klen) < 0)
        return TP_FALL;
    if (klen > (uint64_t)(blen - pos))
        return TP_FALL;
    const uint8_t *kp = body + pos;
    pos += (Py_ssize_t)klen;
    if (tp_expect(body, blen, &pos, 'i') < 0 ||
        tp_read_zigzag(body, blen, &pos, &version) < 0 || pos != blen)
        return TP_FALL;
    if (version > t->latest)
        return TP_FALL; /* must block on version arrival: Python owns waits */
    if (version < t->oldest) {
        if (tp_error_reply(t, out, reply_id, TOO_OLD_NAME) < 0)
            return -1;
        t->hits_get_value++;
        return TP_SERVED;
    }
    PyObject *val = Py_None;
    VSNode *node = vs_search_raw(t->store, kp, (Py_ssize_t)klen);
    if (node != NULL) {
        Py_ssize_t j = chain_bisect(&node->ch, version);
        if (j >= 0)
            val = node->ch.values[j];
    }
    WBuf w = {NULL, 0, 0};
    uint64_t tid = t->tid_gv_rep;
    /* GetValueReply { value: bytes|None, version: int } */
    if (wb_byte(&w, W_MAGIC) < 0 || wb_byte(&w, W_VERSION) < 0 ||
        wb_byte(&w, 'R') < 0 || wb_varint(&w, tid) < 0 ||
        wb_varint(&w, 2) < 0 || wb_bytes_val(&w, val) < 0 ||
        wb_byte(&w, 'i') < 0 || wb_zigzag(&w, version) < 0 ||
        tp_emit_frame(t, out, reply_id, TP_REPLY, w.buf, w.len) < 0) {
        PyMem_Free(w.buf);
        return -1;
    }
    PyMem_Free(w.buf);
    t->hits_get_value++;
    return TP_SERVED;
}

static int tp_serve_get_values(TransportTable *t, uint64_t reply_id,
                               const uint8_t *body, Py_ssize_t blen,
                               WBuf *out) {
    Py_ssize_t pos = 0;
    uint64_t n = 0;
    if (tp_request_head(body, blen, &pos, t->tid_gvs_req, 1) < 0 ||
        tp_expect(body, blen, &pos, 'l') < 0 ||
        tp_read_varint(body, blen, &pos, &n) < 0)
        return TP_FALL;
    /* every read is >= 6 encoded bytes; counts past that bound (or empty
     * batches, which the Python handler treats as malformed) fall back */
    if (n == 0 || n > (uint64_t)(blen - pos) / 6)
        return TP_FALL;
    /* pass 1: validate shape, find the batch version — the handler waits
     * on max(versions) once, then serves the batch at per-read versions */
    Py_ssize_t scan = pos;
    int64_t maxv = INT64_MIN;
    for (uint64_t i = 0; i < n; i++) {
        uint64_t nf = 0, klen = 0;
        int64_t v = 0;
        if (tp_expect(body, blen, &scan, 't') < 0 ||
            tp_read_varint(body, blen, &scan, &nf) < 0 || nf != 2 ||
            tp_expect(body, blen, &scan, 'b') < 0 ||
            tp_read_varint(body, blen, &scan, &klen) < 0)
            return TP_FALL;
        if (klen > (uint64_t)(blen - scan))
            return TP_FALL;
        scan += (Py_ssize_t)klen;
        if (tp_expect(body, blen, &scan, 'i') < 0 ||
            tp_read_zigzag(body, blen, &scan, &v) < 0)
            return TP_FALL;
        if (v > maxv)
            maxv = v;
    }
    if (scan != blen)
        return TP_FALL;
    if (maxv > t->latest)
        return TP_FALL;
    if (maxv < t->oldest) {
        /* whole batch behind the window: batch-unit error, matching the
         * Python handler's single _wait_for_version(max) raise */
        if (tp_error_reply(t, out, reply_id, TOO_OLD_NAME) < 0)
            return -1;
        t->hits_get_values++;
        return TP_SERVED;
    }
    WBuf w = {NULL, 0, 0};
    uint64_t tid = t->tid_gvs_rep;
    if (wb_grow(&w, 64 + (Py_ssize_t)n * 24) < 0)
        return -1;
    w.buf[w.len++] = W_MAGIC;
    w.buf[w.len++] = W_VERSION;
    /* GetValuesReply { results: [(0, value|None) | (1, errname)] } */
    if (wb_byte(&w, 'R') < 0 || wb_varint(&w, tid) < 0 ||
        wb_varint(&w, 1) < 0 || wb_byte(&w, 'l') < 0 ||
        wb_varint(&w, n) < 0)
        goto fail;
    for (uint64_t i = 0; i < n; i++) {
        uint64_t nf = 0, klen = 0;
        int64_t v = 0;
        /* pass 1 proved the shape; re-walk is cheap and allocation-free */
        if (tp_expect(body, blen, &pos, 't') < 0 ||
            tp_read_varint(body, blen, &pos, &nf) < 0 ||
            tp_expect(body, blen, &pos, 'b') < 0 ||
            tp_read_varint(body, blen, &pos, &klen) < 0)
            goto fail;
        if (klen > (uint64_t)(blen - pos))
            goto fail;
        const uint8_t *kp = body + pos;
        pos += (Py_ssize_t)klen;
        if (tp_expect(body, blen, &pos, 'i') < 0 ||
            tp_read_zigzag(body, blen, &pos, &v) < 0)
            goto fail;
        if (wb_byte(&w, 't') < 0 || wb_varint(&w, 2) < 0)
            goto fail;
        if (v < t->oldest) {
            size_t elen = strlen(TOO_OLD_NAME);
            if (wb_byte(&w, 'i') < 0 || wb_varint(&w, 2) < 0 || /* int 1 */
                wb_byte(&w, 's') < 0 || wb_varint(&w, elen) < 0 ||
                wb_raw(&w, TOO_OLD_NAME, elen) < 0)
                goto fail;
        } else {
            PyObject *val = Py_None;
            VSNode *node = vs_search_raw(t->store, kp, (Py_ssize_t)klen);
            if (node != NULL) {
                Py_ssize_t j = chain_bisect(&node->ch, v);
                if (j >= 0)
                    val = node->ch.values[j];
            }
            if (wb_byte(&w, 'i') < 0 || wb_varint(&w, 0) < 0 || /* int 0 */
                wb_bytes_val(&w, val) < 0)
                goto fail;
        }
    }
    if (tp_emit_frame(t, out, reply_id, TP_REPLY, w.buf, w.len) < 0)
        goto fail;
    PyMem_Free(w.buf);
    t->hits_get_values++;
    return TP_SERVED;
fail:
    PyMem_Free(w.buf);
    if (!PyErr_Occurred())
        PyErr_SetString(PyExc_ValueError, "get_values shape drift");
    return -1;
}

/* one encoded KeySelector record; *key_out is a new reference on success.
 * Returns -1 on shape mismatch (no exception) or allocation failure
 * (exception set) — callers split the two on PyErr_Occurred(). */
static int tp_parse_selector(TransportTable *t, const uint8_t *body,
                             Py_ssize_t blen, Py_ssize_t *pos,
                             PyObject **key_out, int *or_equal,
                             int64_t *offset) {
    uint64_t tid = 0, nf = 0, klen = 0;
    if (tp_expect(body, blen, pos, 'R') < 0 ||
        tp_read_varint(body, blen, pos, &tid) < 0 || tid != t->tid_sel ||
        tp_read_varint(body, blen, pos, &nf) < 0 || nf != 3 ||
        tp_expect(body, blen, pos, 'b') < 0 ||
        tp_read_varint(body, blen, pos, &klen) < 0)
        return -1;
    if (klen > (uint64_t)(blen - *pos))
        return -1;
    const uint8_t *kp = body + *pos;
    *pos += (Py_ssize_t)klen;
    if (*pos >= blen)
        return -1;
    uint8_t flag = body[(*pos)++];
    if (flag != 'T' && flag != 'F')
        return -1;
    *or_equal = flag == 'T';
    if (tp_expect(body, blen, pos, 'i') < 0 ||
        tp_read_zigzag(body, blen, pos, offset) < 0)
        return -1;
    PyObject *k = PyBytes_FromStringAndSize((const char *)kp,
                                            (Py_ssize_t)klen);
    if (!k)
        return -1;
    *key_out = k;
    return 0;
}

static int tp_serve_get_range(TransportTable *t, uint64_t reply_id,
                              const uint8_t *body, Py_ssize_t blen,
                              WBuf *out) {
    Py_ssize_t pos = 0;
    PyObject *bkey = NULL, *ekey = NULL, *bres = NULL, *eres = NULL;
    int b_eq = 0, e_eq = 0, reverse = 0;
    int64_t b_off = 0, e_off = 0, version = 0, limit = 0, limit_bytes = 0;
    int rc = TP_FALL;
    if (tp_request_head(body, blen, &pos, t->tid_gkv_req, 6) < 0)
        return TP_FALL;
    if (tp_parse_selector(t, body, blen, &pos, &bkey, &b_eq, &b_off) < 0)
        return PyErr_Occurred() ? -1 : TP_FALL;
    if (tp_parse_selector(t, body, blen, &pos, &ekey, &e_eq, &e_off) < 0) {
        Py_DECREF(bkey);
        return PyErr_Occurred() ? -1 : TP_FALL;
    }
    if (tp_expect(body, blen, &pos, 'i') < 0 ||
        tp_read_zigzag(body, blen, &pos, &version) < 0 ||
        tp_expect(body, blen, &pos, 'i') < 0 ||
        tp_read_zigzag(body, blen, &pos, &limit) < 0 ||
        tp_expect(body, blen, &pos, 'i') < 0 ||
        tp_read_zigzag(body, blen, &pos, &limit_bytes) < 0 ||
        pos + 1 != blen || (body[pos] != 'T' && body[pos] != 'F'))
        goto done;
    reverse = body[pos] == 'T';
    if (limit < 0 || limit_bytes < 0)
        goto done; /* odd inputs: the Python handler is the authority */
    if (version > t->latest)
        goto done;
    if (version < t->oldest) {
        if (tp_error_reply(t, out, reply_id, TOO_OLD_NAME) < 0)
            goto done_err;
        t->hits_get_range++;
        rc = TP_SERVED;
        goto done;
    }
    bres = vs_selector_core(t->store, bkey, b_eq, (Py_ssize_t)b_off,
                            version);
    if (bres == NULL)
        goto done_err;
    eres = vs_selector_core(t->store, ekey, e_eq, (Py_ssize_t)e_off,
                            version);
    if (eres == NULL)
        goto done_err;
    if (om_keycmp(eres, bres) < 0) {
        /* end < begin clamps to an empty range (storage _get_key_values) */
        Py_DECREF(eres);
        eres = Py_NewRef(bres);
    }
    if (limit_bytes == 0)
        limit_bytes = t->default_limit_bytes;
    {
        WBuf items = {NULL, 0, 0};
        struct vs_wire_ctx cctx = {&items, 0};
        int more = 0;
        if (vs_scan(t->store, bres, eres, version, (Py_ssize_t)limit,
                    (Py_ssize_t)limit_bytes, reverse, vs_emit_wire, &cctx,
                    &more) < 0) {
            PyMem_Free(items.buf);
            goto done_err;
        }
        WBuf w = {NULL, 0, 0};
        uint64_t tid = t->tid_gkv_rep;
        uint64_t count = (uint64_t)cctx.count;
        if (wb_grow(&w, 32 + items.len) < 0) {
            PyMem_Free(items.buf);
            goto done_err;
        }
        w.buf[w.len++] = W_MAGIC;
        w.buf[w.len++] = W_VERSION;
        /* GetKeyValuesReply { data: [(k, v)], more: bool, version: int } */
        if (wb_byte(&w, 'R') < 0 || wb_varint(&w, tid) < 0 ||
            wb_varint(&w, 3) < 0 || wb_byte(&w, 'l') < 0 ||
            wb_varint(&w, count) < 0 ||
            wb_raw(&w, items.buf, items.len) < 0 ||
            wb_byte(&w, more ? 'T' : 'F') < 0 || wb_byte(&w, 'i') < 0 ||
            wb_zigzag(&w, version) < 0 ||
            tp_emit_frame(t, out, reply_id, TP_REPLY, w.buf, w.len) < 0) {
            PyMem_Free(items.buf);
            PyMem_Free(w.buf);
            goto done_err;
        }
        PyMem_Free(items.buf);
        PyMem_Free(w.buf);
    }
    t->hits_get_range++;
    rc = TP_SERVED;
    goto done;
done_err:
    rc = -1;
done:
    Py_XDECREF(bkey);
    Py_XDECREF(ekey);
    Py_XDECREF(bres);
    Py_XDECREF(eres);
    return rc;
}

static int tp_serve_grv(TransportTable *t, uint64_t reply_id,
                        const uint8_t *body, Py_ssize_t blen, WBuf *out) {
    Py_ssize_t pos = 0;
    int64_t priority = 0, count = 1;
    uint64_t tid = 0, nf = 0;
    if (blen < 2 || body[0] != W_MAGIC || body[1] != W_VERSION)
        return TP_FALL;
    pos = 2;
    /* count is trailing-defaulted on GetReadVersionRequest, so both the
     * 2-field (older encoders) and 3-field forms are live on the wire */
    if (tp_expect(body, blen, &pos, 'R') < 0 ||
        tp_read_varint(body, blen, &pos, &tid) < 0 ||
        tid != t->tid_grv_req ||
        tp_read_varint(body, blen, &pos, &nf) < 0 ||
        (nf != 2 && nf != 3) ||
        tp_expect(body, blen, &pos, 'i') < 0 ||
        tp_read_zigzag(body, blen, &pos, &priority) < 0 || pos >= blen)
        return TP_FALL;
    if (body[pos] == 'N') {
        pos++;
    } else if (body[pos] == 's') {
        /* debug span id: the GRV handler never reads it (only commits
         * attach spans), so skip the string rather than falling — the
         * client stamps one on EVERY real-path GRV */
        uint64_t slen = 0;
        pos++;
        if (tp_read_varint(body, blen, &pos, &slen) < 0 ||
            slen > (uint64_t)(blen - pos))
            return TP_FALL;
        pos += (Py_ssize_t)slen;
    } else {
        return TP_FALL;
    }
    if (nf == 3) {
        if (tp_expect(body, blen, &pos, 'i') < 0 ||
            tp_read_zigzag(body, blen, &pos, &count) < 0 || count < 1)
            return TP_FALL;
    }
    if (pos != blen)
        return TP_FALL;
    if (priority != 0 || t->grv_allowance < count || t->grv_version < 0)
        return TP_FALL;
    WBuf w = {NULL, 0, 0};
    int64_t version = t->grv_version;
    uint64_t rtid = t->tid_grv_rep;
    /* GetReadVersionReply { version: int } */
    if (wb_byte(&w, W_MAGIC) < 0 || wb_byte(&w, W_VERSION) < 0 ||
        wb_byte(&w, 'R') < 0 || wb_varint(&w, rtid) < 0 ||
        wb_varint(&w, 1) < 0 || wb_byte(&w, 'i') < 0 ||
        wb_zigzag(&w, version) < 0 ||
        tp_emit_frame(t, out, reply_id, TP_REPLY, w.buf, w.len) < 0) {
        PyMem_Free(w.buf);
        return -1;
    }
    PyMem_Free(w.buf);
    /* spend the batched transaction count, not 1 per wire request, so the
     * allowance and the hit counter line up with the Python path's
     * ratekeeper token spend */
    t->grv_allowance -= count;
    t->hits_grv += (uint64_t)count;
    return TP_SERVED;
}

static int tp_fast_serve(TransportTable *t, uint64_t token,
                         uint64_t reply_id, const uint8_t *body,
                         Py_ssize_t blen, WBuf *out) {
    if (t->store != NULL) {
        if (token == t->tok_get_value)
            return tp_serve_get_value(t, reply_id, body, blen, out);
        if (token == t->tok_get_values)
            return tp_serve_get_values(t, reply_id, body, blen, out);
        if (token == t->tok_get_range)
            return tp_serve_get_range(t, reply_id, body, blen, out);
    }
    if (t->grv_on && token == t->tok_grv)
        return tp_serve_grv(t, reply_id, body, blen, out);
    return TP_FALL;
}

/* -- TransportTable methods -- */

static PyObject *tt_new(PyTypeObject *type, PyObject *args, PyObject *kwds) {
    if ((args != NULL && PyTuple_GET_SIZE(args) > 0) ||
        (kwds != NULL && PyDict_GET_SIZE(kwds) > 0)) {
        PyErr_SetString(PyExc_TypeError, "TransportTable takes no arguments");
        return NULL;
    }
    TransportTable *self = (TransportTable *)type->tp_alloc(type, 0);
    if (!self)
        return NULL;
    self->grv_version = -1;
    return (PyObject *)self;
}

static void tt_dealloc(TransportTable *self) {
    Py_CLEAR(self->store);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *tt_enable_storage(TransportTable *self, PyObject *args) {
    PyObject *store;
    unsigned long long tok_gv, tok_gvs, tok_gkv;
    unsigned long long tid_gv_req, tid_gv_rep, tid_gvs_req, tid_gvs_rep;
    unsigned long long tid_gkv_req, tid_gkv_rep, tid_sel;
    long long oldest, latest, dlb;
    if (!PyArg_ParseTuple(args, "O!KKKKKKKKKKLLL", &VStoreType, &store,
                          &tok_gv, &tok_gvs, &tok_gkv, &tid_gv_req,
                          &tid_gv_rep, &tid_gvs_req, &tid_gvs_rep,
                          &tid_gkv_req, &tid_gkv_rep, &tid_sel, &oldest,
                          &latest, &dlb))
        return NULL;
    Py_INCREF(store);
    Py_XSETREF(self->store, (VStore *)store);
    self->tok_get_value = tok_gv;
    self->tok_get_values = tok_gvs;
    self->tok_get_range = tok_gkv;
    self->tid_gv_req = tid_gv_req;
    self->tid_gv_rep = tid_gv_rep;
    self->tid_gvs_req = tid_gvs_req;
    self->tid_gvs_rep = tid_gvs_rep;
    self->tid_gkv_req = tid_gkv_req;
    self->tid_gkv_rep = tid_gkv_rep;
    self->tid_sel = tid_sel;
    self->oldest = oldest;
    self->latest = latest;
    self->default_limit_bytes = dlb;
    Py_RETURN_NONE;
}

static PyObject *tt_set_read_bounds(TransportTable *self, PyObject *args) {
    long long oldest, latest;
    if (!PyArg_ParseTuple(args, "LL", &oldest, &latest))
        return NULL;
    self->oldest = oldest;
    self->latest = latest;
    Py_RETURN_NONE;
}

static PyObject *tt_disable_storage(TransportTable *self, PyObject *noarg) {
    (void)noarg;
    Py_CLEAR(self->store);
    Py_RETURN_NONE;
}

static PyObject *tt_enable_grv(TransportTable *self, PyObject *args) {
    unsigned long long tok, tid_req, tid_rep;
    if (!PyArg_ParseTuple(args, "KKK", &tok, &tid_req, &tid_rep))
        return NULL;
    self->tok_grv = tok;
    self->tid_grv_req = tid_req;
    self->tid_grv_rep = tid_rep;
    self->grv_on = 1;
    Py_RETURN_NONE;
}

static PyObject *tt_set_grv(TransportTable *self, PyObject *args) {
    long long version, allowance;
    if (!PyArg_ParseTuple(args, "LL", &version, &allowance))
        return NULL;
    self->grv_version = version;
    self->grv_allowance = allowance;
    Py_RETURN_NONE;
}

static PyObject *tt_disable_grv(TransportTable *self, PyObject *noarg) {
    (void)noarg;
    self->grv_on = 0;
    Py_RETURN_NONE;
}

static int tt_dict_set(PyObject *d, const char *k, uint64_t v) {
    PyObject *o = PyLong_FromUnsignedLongLong(v);
    if (!o)
        return -1;
    int rc = PyDict_SetItemString(d, k, o);
    Py_DECREF(o);
    return rc;
}

static PyObject *tt_counters(TransportTable *self, PyObject *noarg) {
    (void)noarg;
    PyObject *d = PyDict_New();
    if (!d)
        return NULL;
    uint64_t hits = self->hits_get_value + self->hits_get_values +
                    self->hits_get_range + self->hits_grv;
    if (tt_dict_set(d, "FramesIn", self->frames_in) < 0 ||
        tt_dict_set(d, "FramesOut", self->frames_out) < 0 ||
        tt_dict_set(d, "BytesIn", self->bytes_in) < 0 ||
        tt_dict_set(d, "BytesOut", self->bytes_out) < 0 ||
        tt_dict_set(d, "ChecksumRejects", self->checksum_rejects) < 0 ||
        tt_dict_set(d, "NativeFastPathHits", hits) < 0 ||
        tt_dict_set(d, "PySlowPathFalls", self->slow_falls) < 0 ||
        tt_dict_set(d, "NativeGetValueHits", self->hits_get_value) < 0 ||
        tt_dict_set(d, "NativeGetValuesHits", self->hits_get_values) < 0 ||
        tt_dict_set(d, "NativeGetRangeHits", self->hits_get_range) < 0 ||
        tt_dict_set(d, "NativeGRVHits", self->hits_grv) < 0) {
        Py_DECREF(d);
        return NULL;
    }
    return d;
}

static PyMethodDef tt_methods[] = {
    {"enable_storage", (PyCFunction)tt_enable_storage, METH_VARARGS,
     "enable_storage(vstore, tok_gv, tok_gvs, tok_gkv, tid_gv_req, "
     "tid_gv_rep, tid_gvs_req, tid_gvs_rep, tid_gkv_req, tid_gkv_rep, "
     "tid_sel, oldest, latest, default_limit_bytes)"},
    {"set_read_bounds", (PyCFunction)tt_set_read_bounds, METH_VARARGS,
     "set_read_bounds(oldest, latest): the MVCC window C may answer in"},
    {"disable_storage", (PyCFunction)tt_disable_storage, METH_NOARGS,
     "disable_storage(): every storage token falls back to Python"},
    {"enable_grv", (PyCFunction)tt_enable_grv, METH_VARARGS,
     "enable_grv(token, tid_req, tid_rep)"},
    {"set_grv", (PyCFunction)tt_set_grv, METH_VARARGS,
     "set_grv(version, allowance): committed version + reply budget"},
    {"disable_grv", (PyCFunction)tt_disable_grv, METH_NOARGS,
     "disable_grv(): GRV requests fall back to Python"},
    {"counters", (PyCFunction)tt_counters, METH_NOARGS,
     "counters() -> dict of cumulative transport counters"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject TransportTableType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "fdb_native.TransportTable",
    .tp_basicsize = sizeof(TransportTable),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = tt_new,
    .tp_dealloc = (destructor)tt_dealloc,
    .tp_methods = tt_methods,
    .tp_doc = "per-transport native dispatch config + counters",
};

/* -- TransportConn: one connection's rx buffer + frame loop -- */

typedef struct {
    PyObject_HEAD
    TransportTable *table; /* owned */
    uint8_t *rx;
    Py_ssize_t rx_len, rx_cap;
    int dead;
} TransportConn;

static int tc_reserve(TransportConn *self, Py_ssize_t extra) {
    Py_ssize_t need = self->rx_len + extra;
    if (need <= self->rx_cap)
        return 0;
    Py_ssize_t cap = self->rx_cap * 2;
    if (cap < need)
        cap = need + 4096;
    uint8_t *nb = PyMem_Realloc(self->rx, cap);
    if (!nb) {
        PyErr_NoMemory();
        return -1;
    }
    self->rx = nb;
    self->rx_cap = cap;
    return 0;
}

static PyObject *tc_new(PyTypeObject *type, PyObject *args, PyObject *kwds) {
    PyObject *table;
    if (kwds != NULL && PyDict_GET_SIZE(kwds) > 0) {
        PyErr_SetString(PyExc_TypeError,
                        "TransportConn takes no keyword arguments");
        return NULL;
    }
    if (!PyArg_ParseTuple(args, "O!", &TransportTableType, &table))
        return NULL;
    TransportConn *self = (TransportConn *)type->tp_alloc(type, 0);
    if (!self)
        return NULL;
    Py_INCREF(table);
    self->table = (TransportTable *)table;
    return (PyObject *)self;
}

static void tc_dealloc(TransportConn *self) {
    Py_CLEAR(self->table);
    PyMem_Free(self->rx);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

/* feed(data) -> (reply_bytes|None, [(token, reply_id, kind, body), ...],
 * err|None). Complete frames are consumed: fast-path requests append
 * reply frames to reply_bytes, everything else lands in the slow list
 * with its CRC-verified body for the Python dispatcher. A torn tail
 * stays buffered for the next feed. `err` reports the first reject
 * (checksum mismatch / oversized length) in-band so replies produced
 * earlier in the same chunk still reach the peer before the caller
 * drops the connection — matching the Python loop's sequential order. */
static PyObject *tc_feed(TransportConn *self, PyObject *args) {
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "y*", &data))
        return NULL;
    if (self->dead) {
        PyBuffer_Release(&data);
        PyErr_SetString(PyExc_ValueError,
                        "feed() on a failed transport connection");
        return NULL;
    }
    if (tc_reserve(self, data.len) < 0) {
        PyBuffer_Release(&data);
        return NULL;
    }
    memcpy(self->rx + self->rx_len, data.buf, data.len);
    self->rx_len += data.len;
    PyBuffer_Release(&data);

    TransportTable *t = self->table;
    WBuf out = {NULL, 0, 0};
    const char *err = NULL;
    PyObject *slow = PyList_New(0);
    if (!slow)
        return NULL;
    Py_ssize_t pos = 0;
    while (self->rx_len - pos >= TP_HEADER_LEN) {
        const uint8_t *h = self->rx + pos;
        Py_ssize_t length = (Py_ssize_t)tp_load_u32(h);
        if (length > TP_MAX_FRAME) {
            err = "oversized frame";
            break;
        }
        if (self->rx_len - pos - TP_HEADER_LEN < length)
            break; /* torn frame: keep the prefix for the next feed */
        uint64_t token = tp_load_u64(h + 4);
        uint64_t reply_id = tp_load_u64(h + 12);
        int kind = h[20];
        uint32_t want = tp_load_u32(h + 21);
        const uint8_t *fb = h + TP_HEADER_LEN;
        uint32_t got;
        if (length >= TP_GIL_CRC_MIN) {
            Py_BEGIN_ALLOW_THREADS
            got = crc32c_sw(0, fb, length);
            Py_END_ALLOW_THREADS
        } else {
            got = crc32c_sw(0, fb, length);
        }
        if (got != want) {
            t->checksum_rejects++;
            err = "packet checksum mismatch";
            break;
        }
        t->frames_in++;
        t->bytes_in += (uint64_t)(TP_HEADER_LEN + length);
        pos += TP_HEADER_LEN + length;
        int st = TP_FALL;
        if (kind == TP_REQUEST)
            st = tp_fast_serve(t, token, reply_id, fb, length, &out);
        if (st < 0)
            goto fail;
        if (st == TP_FALL) {
            t->slow_falls++;
            PyObject *tup = Py_BuildValue("(KKiy#)", token, reply_id, kind,
                                          (const char *)fb, length);
            if (!tup)
                goto fail;
            int rc = PyList_Append(slow, tup);
            Py_DECREF(tup);
            if (rc < 0)
                goto fail;
        }
    }
    if (pos > 0) {
        memmove(self->rx, self->rx + pos, self->rx_len - pos);
        self->rx_len -= pos;
    }
    if (err != NULL)
        self->dead = 1;
    PyObject *replies;
    if (out.len > 0) {
        replies = PyBytes_FromStringAndSize((const char *)out.buf, out.len);
        if (!replies)
            goto fail;
    } else {
        replies = Py_NewRef(Py_None);
    }
    PyMem_Free(out.buf);
    out.buf = NULL;
    PyObject *err_obj = err ? PyUnicode_FromString(err) : Py_NewRef(Py_None);
    if (!err_obj) {
        Py_DECREF(replies);
        goto fail;
    }
    PyObject *ret = PyTuple_New(3);
    if (!ret) {
        Py_DECREF(replies);
        Py_DECREF(err_obj);
        goto fail;
    }
    PyTuple_SET_ITEM(ret, 0, replies);
    PyTuple_SET_ITEM(ret, 1, slow);
    PyTuple_SET_ITEM(ret, 2, err_obj);
    return ret;
fail:
    PyMem_Free(out.buf);
    Py_DECREF(slow);
    return NULL;
}

/* residue() -> buffered-but-unparsed bytes, for handing a connection
 * back to the pure-Python serve loop mid-stream */
static PyObject *tc_residue(TransportConn *self, PyObject *noarg) {
    (void)noarg;
    if (self->rx_len == 0)
        return PyBytes_FromStringAndSize("", 0);
    return PyBytes_FromStringAndSize((const char *)self->rx, self->rx_len);
}

static PyMethodDef tc_methods[] = {
    {"feed", (PyCFunction)tc_feed, METH_VARARGS,
     "feed(data) -> (reply_bytes|None, slow_frames, err|None)"},
    {"residue", (PyCFunction)tc_residue, METH_NOARGS,
     "residue() -> buffered unparsed bytes"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject TransportConnType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "fdb_native.TransportConn",
    .tp_basicsize = sizeof(TransportConn),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = tc_new,
    .tp_dealloc = (destructor)tc_dealloc,
    .tp_methods = tc_methods,
    .tp_doc = "one connection's native frame loop over a TransportTable",
};

/* ------------------------------------------------------------------ */
/* Native client plane (net/native_transport.py client binding)        */
/*                                                                     */
/* The inverse of the server section above: the client's hot read      */
/* tokens (GET_VALUE / GET_VALUES / GET_KEY_VALUES / GRV) spend their  */
/* wire time in two per-request Python round trips — wire.dumps +      */
/* frame + crc32c on send, readexactly + header unpack + wire.loads    */
/* on receive. transport_client_encode() collapses the send side to    */
/* one C call per socket write; ClientConn collapses the receive side  */
/* to one C call per socket read that hands back a settled-batch the   */
/* Python loop resolves futures from. Request/reply payloads ride the  */
/* generic registered-struct codec (enc_value / dec_value), so the     */
/* client plane transports the pinned schemas below (PROTO005 holds    */
/* the field lists against the Python dataclasses).                    */
/* Anything the codec cannot express raises OverflowError and the      */
/* Python wrapper re-runs the pure-Python path, which stays the        */
/* semantic authority (three-way fuzz: tests/test_native_client.py).   */
/*
     GetValueRequest { key: bytes, version: int }
     GetValuesRequest { reads: list }
     GetKeyValuesRequest { begin: KeySelector, end: KeySelector,
                           version: int, limit: int, limit_bytes: int,
                           reverse: bool }
     GetReadVersionRequest { priority: int, debug_id: str|None,
                             count: int }
*/
/* ------------------------------------------------------------------ */

/* transport_client_encode([(token, reply_id, payload), ...]) -> bytes
 * One framed, CRC-stamped send buffer for the whole batch, byte-
 * identical to concatenating transport_frame(token, reply_id, REQUEST,
 * wire.dumps(payload)) per item. */
static PyObject *py_transport_client_encode(PyObject *self, PyObject *arg) {
    PyObject *seq = PySequence_Fast(arg, "encode batch must be a sequence");
    if (!seq)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    WBuf out = {NULL, 0, 0};
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 3) {
            PyErr_SetString(
                PyExc_TypeError,
                "encode batch item must be (token, reply_id, payload)");
            goto fail;
        }
        uint64_t token =
            PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(item, 0));
        if (token == (uint64_t)-1 && PyErr_Occurred())
            goto fail;
        uint64_t reply_id =
            PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(item, 1));
        if (reply_id == (uint64_t)-1 && PyErr_Occurred())
            goto fail;
        Py_ssize_t hoff = out.len;
        if (wb_grow(&out, TP_HEADER_LEN + 64) < 0)
            goto fail;
        out.len += TP_HEADER_LEN; /* header backfilled once the body
                                     length and CRC are known */
        Py_ssize_t boff = out.len;
        if (wb_byte(&out, W_MAGIC) < 0 || wb_byte(&out, W_VERSION) < 0 ||
            enc_value(&out, PyTuple_GET_ITEM(item, 2), 0) < 0)
            goto fail; /* OverflowError -> wrapper falls back */
        Py_ssize_t blen = out.len - boff;
        if (blen > TP_MAX_FRAME) {
            PyErr_SetString(PyExc_ValueError,
                            "frame body over TP_MAX_FRAME");
            goto fail;
        }
        uint32_t crc;
        if (blen >= TP_GIL_CRC_MIN) {
            Py_BEGIN_ALLOW_THREADS
            crc = crc32c_sw(0, out.buf + boff, blen);
            Py_END_ALLOW_THREADS
        } else {
            crc = crc32c_sw(0, out.buf + boff, blen);
        }
        /* out.buf may have moved during enc_value: locate the header
         * through the stable offset, never a saved pointer */
        uint8_t *h = out.buf + hoff;
        tp_store_u32(h, (uint32_t)blen);
        tp_store_u64(h + 4, token);
        tp_store_u64(h + 12, reply_id);
        h[20] = TP_REQUEST;
        tp_store_u32(h + 21, crc);
    }
    PyObject *ret =
        PyBytes_FromStringAndSize((const char *)out.buf, out.len);
    PyMem_Free(out.buf);
    Py_DECREF(seq);
    return ret;
fail:
    PyMem_Free(out.buf);
    Py_DECREF(seq);
    return NULL;
}

/* -- ClientConn: one outbound connection's reply pump -- */

typedef struct {
    PyObject_HEAD
    uint8_t *rx;
    Py_ssize_t rx_len, rx_cap;
    int dead;
} ClientConn;

static int cc_reserve(ClientConn *self, Py_ssize_t extra) {
    Py_ssize_t need = self->rx_len + extra;
    if (need <= self->rx_cap)
        return 0;
    Py_ssize_t cap = self->rx_cap * 2;
    if (cap < need)
        cap = need + 4096;
    uint8_t *nb = PyMem_Realloc(self->rx, cap);
    if (!nb) {
        PyErr_NoMemory();
        return -1;
    }
    self->rx = nb;
    self->rx_cap = cap;
    return 0;
}

static PyObject *cc_new(PyTypeObject *type, PyObject *args, PyObject *kwds) {
    if ((kwds != NULL && PyDict_GET_SIZE(kwds) > 0) ||
        (args != NULL && PyTuple_GET_SIZE(args) > 0)) {
        PyErr_SetString(PyExc_TypeError, "ClientConn takes no arguments");
        return NULL;
    }
    return type->tp_alloc(type, 0);
}

static void cc_dealloc(ClientConn *self) {
    PyMem_Free(self->rx);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

/* feed(data) -> ([(reply_id, kind, payload, raw), ...], err|None).
 * Complete frames are consumed; a torn tail stays buffered. Each entry
 * carries either a C-decoded payload (raw is None) or, when the body
 * needs the Python codec — >64-bit varints, schema skew, unknown ids,
 * an older wire version — payload is None and raw holds the CRC-
 * verified body for wire.loads (the per-frame fallback the wrapper
 * counts as ClientPyFalls). `err` reports the first protocol reject
 * (checksum mismatch / oversized length) in-band so entries parsed
 * earlier in the same chunk still settle their futures before the
 * caller drops the connection — matching the Python loop's order.
 * Divergence from the Python loop, documented in
 * docs/native_transport.md: the pump CRC-checks every frame including
 * ones whose reply_id no longer has a pending future (the Python loop
 * skips verification for those), so a corrupt late duplicate kills the
 * connection here but is ignored there. Strictly stricter. */
static PyObject *cc_feed(ClientConn *self, PyObject *args) {
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "y*", &data))
        return NULL;
    if (self->dead) {
        PyBuffer_Release(&data);
        PyErr_SetString(PyExc_ValueError,
                        "feed() on a failed client connection");
        return NULL;
    }
    if (cc_reserve(self, data.len) < 0) {
        PyBuffer_Release(&data);
        return NULL;
    }
    memcpy(self->rx + self->rx_len, data.buf, data.len);
    self->rx_len += data.len;
    PyBuffer_Release(&data);

    const char *err = NULL;
    PyObject *entries = PyList_New(0);
    if (!entries)
        return NULL;
    Py_ssize_t pos = 0;
    while (self->rx_len - pos >= TP_HEADER_LEN) {
        const uint8_t *h = self->rx + pos;
        Py_ssize_t length = (Py_ssize_t)tp_load_u32(h);
        if (length > TP_MAX_FRAME) {
            err = "oversized frame";
            break;
        }
        if (self->rx_len - pos - TP_HEADER_LEN < length)
            break; /* torn frame: keep the prefix for the next feed */
        uint64_t reply_id = tp_load_u64(h + 12);
        int kind = h[20];
        uint32_t want = tp_load_u32(h + 21);
        const uint8_t *fb = h + TP_HEADER_LEN;
        uint32_t got;
        if (length >= TP_GIL_CRC_MIN) {
            Py_BEGIN_ALLOW_THREADS
            got = crc32c_sw(0, fb, length);
            Py_END_ALLOW_THREADS
        } else {
            got = crc32c_sw(0, fb, length);
        }
        if (got != want) {
            err = "packet checksum mismatch";
            break;
        }
        pos += TP_HEADER_LEN + length;
        PyObject *payload = NULL;
        if ((kind == TP_REPLY || kind == TP_REPLY_ERROR) && length >= 2 &&
            fb[0] == W_MAGIC && fb[1] == W_VERSION) {
            RBuf r = {fb + 2, fb + length};
            payload = dec_value(&r, 0);
            if (payload && r.p != r.end)
                Py_CLEAR(payload); /* trailing bytes: Python owns reject */
            if (!payload)
                PyErr_Clear(); /* per-frame fallback, never an error */
        }
        PyObject *tup;
        if (payload) {
            tup = Py_BuildValue("(KiOO)", reply_id, kind, payload, Py_None);
            Py_DECREF(payload);
        } else {
            tup = Py_BuildValue("(KiOy#)", reply_id, kind, Py_None,
                                (const char *)fb, length);
        }
        if (!tup)
            goto fail;
        int rc = PyList_Append(entries, tup);
        Py_DECREF(tup);
        if (rc < 0)
            goto fail;
    }
    if (pos > 0) {
        memmove(self->rx, self->rx + pos, self->rx_len - pos);
        self->rx_len -= pos;
    }
    if (err != NULL)
        self->dead = 1;
    PyObject *err_obj = err ? PyUnicode_FromString(err) : Py_NewRef(Py_None);
    if (!err_obj)
        goto fail;
    PyObject *ret = PyTuple_New(2);
    if (!ret) {
        Py_DECREF(err_obj);
        goto fail;
    }
    PyTuple_SET_ITEM(ret, 0, entries);
    PyTuple_SET_ITEM(ret, 1, err_obj);
    return ret;
fail:
    Py_DECREF(entries);
    return NULL;
}

/* residue() -> buffered-but-unparsed bytes, for handing the connection
 * back to the pure-Python reply loop mid-stream */
static PyObject *cc_residue(ClientConn *self, PyObject *noarg) {
    (void)noarg;
    if (self->rx_len == 0)
        return PyBytes_FromStringAndSize("", 0);
    return PyBytes_FromStringAndSize((const char *)self->rx, self->rx_len);
}

static PyMethodDef cc_methods[] = {
    {"feed", (PyCFunction)cc_feed, METH_VARARGS,
     "feed(data) -> ([(reply_id, kind, payload, raw), ...], err|None)"},
    {"residue", (PyCFunction)cc_residue, METH_NOARGS,
     "residue() -> buffered unparsed bytes"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject ClientConnType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "fdb_native.ClientConn",
    .tp_basicsize = sizeof(ClientConn),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = cc_new,
    .tp_dealloc = (destructor)cc_dealloc,
    .tp_methods = cc_methods,
    .tp_doc = "one outbound connection's native reply pump",
};

static PyMethodDef methods[] = {
    {"crc32c", py_crc32c, METH_VARARGS,
     "crc32c(data, init=0) -> CRC-32C checksum"},
    {"redwood_encode_block", py_redwood_encode_block, METH_O,
     "redwood_encode_block([(key, value), ...]) -> bytes (sorted keys, "
     "prefix-compressed; bit-identical to storage/redwood.py "
     "py_encode_block)"},
    {"redwood_decode_block", py_redwood_decode_block, METH_O,
     "redwood_decode_block(bytes) -> [(key, value), ...]"},
    {"redwood_bloom_build", py_redwood_bloom_build, METH_VARARGS,
     "redwood_bloom_build(keys, bits_per_key, n_hashes) -> bloom section "
     "bytes (bit-identical to storage/redwood.py py_bloom_build)"},
    {"redwood_bloom_query", py_redwood_bloom_query, METH_VARARGS,
     "redwood_bloom_query(section, key) -> bool (False = definitely absent)"},
    {"redwood_run_open", py_redwood_run_open, METH_VARARGS,
     "redwood_run_open(image, clears, cache_blocks) -> RedwoodRun handle"},
    {"redwood_runs_get", py_redwood_runs_get, METH_VARARGS,
     "redwood_runs_get(runs_newest_first, key) -> value | None"},
    {"redwood_runs_get_batch", py_redwood_runs_get_batch, METH_VARARGS,
     "redwood_runs_get_batch(runs_newest_first, keys) -> [value | None]"},
    {"redwood_runs_get_many_encode", py_redwood_runs_get_many_encode,
     METH_VARARGS,
     "redwood_runs_get_many_encode(runs, reads, oldest, tid, prefilled) -> "
     "GetValuesReply wire frame"},
    {"encode_conflict_ranges", py_encode_conflict_ranges, METH_VARARGS,
     "encode_conflict_ranges(txns, skip_or_None, rb, re, wb, we, rtxn, "
     "wtxn, key_bytes, snap, valid, base_version, rstride, wstride) -> "
     "(n_reads, n_writes): the port's packed batch in one pass"},
    {"encode_keys_into", py_encode_keys_into, METH_VARARGS,
     "encode_keys_into(keys, out_u32_buffer, round_up=False, key_bytes=24)\nkey_bytes MUST match the buffer layout: out has key_bytes/4+1 limb rows."},
    {"wire_set_registry", py_wire_set_registry, METH_VARARGS,
     "wire_set_registry(by_id, by_type): install the typed-codec registry"},
    {"wire_dumps", py_wire_dumps, METH_O,
     "wire_dumps(obj) -> bytes (raises OverflowError when the pure-Python "
     "codec must handle the value)"},
    {"wire_loads", py_wire_loads, METH_O, "wire_loads(bytes) -> obj"},
    {"transport_frame", py_transport_frame, METH_VARARGS,
     "transport_frame(token, reply_id, kind, body) -> framed bytes "
     "(byte-identical to transport.py _frame)"},
    {"transport_client_encode", py_transport_client_encode, METH_O,
     "transport_client_encode([(token, reply_id, payload), ...]) -> one "
     "framed, CRC-stamped send buffer (byte-identical to per-request "
     "wire.dumps + transport_frame)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fdb_native", NULL, -1, methods};

PyMODINIT_FUNC PyInit_fdb_native(void) {
    crc32c_init();
    if (PyType_Ready(&OMapType) < 0 || PyType_Ready(&VStoreType) < 0 ||
        PyType_Ready(&RedwoodRunType) < 0 ||
        PyType_Ready(&TransportTableType) < 0 ||
        PyType_Ready(&TransportConnType) < 0 ||
        PyType_Ready(&ClientConnType) < 0)
        return NULL;
    g_zero = PyLong_FromLong(0);
    g_too_old_pair = Py_BuildValue("(is)", 1, TOO_OLD_NAME);
    g_sel_end = PyBytes_FromStringAndSize("\xff\xff", 2);
    g_sel_begin = PyBytes_FromStringAndSize("", 0);
    g_hi32 = PyBytes_FromStringAndSize(
        "\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff"
        "\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff",
        32);
    if (!g_zero || !g_too_old_pair || !g_sel_end || !g_sel_begin || !g_hi32)
        return NULL;
    PyObject *m = PyModule_Create(&moduledef);
    if (!m)
        return NULL;
    Py_INCREF(&OMapType);
    if (PyModule_AddObject(m, "IndexedSet", (PyObject *)&OMapType) < 0) {
        Py_DECREF(&OMapType);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&VStoreType);
    if (PyModule_AddObject(m, "VStore", (PyObject *)&VStoreType) < 0) {
        Py_DECREF(&VStoreType);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&RedwoodRunType);
    if (PyModule_AddObject(m, "RedwoodRun", (PyObject *)&RedwoodRunType)
            < 0) {
        Py_DECREF(&RedwoodRunType);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&TransportTableType);
    if (PyModule_AddObject(m, "TransportTable",
                           (PyObject *)&TransportTableType) < 0) {
        Py_DECREF(&TransportTableType);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&TransportConnType);
    if (PyModule_AddObject(m, "TransportConn",
                           (PyObject *)&TransportConnType) < 0) {
        Py_DECREF(&TransportConnType);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&ClientConnType);
    if (PyModule_AddObject(m, "ClientConn", (PyObject *)&ClientConnType)
            < 0) {
        Py_DECREF(&ClientConnType);
        Py_DECREF(m);
        return NULL;
    }
    if (PyModule_AddIntConstant(m, "TRANSPORT_MAX_FRAME", TP_MAX_FRAME) < 0 ||
        PyModule_AddIntConstant(m, "TRANSPORT_HEADER_LEN", TP_HEADER_LEN)
            < 0) {
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
