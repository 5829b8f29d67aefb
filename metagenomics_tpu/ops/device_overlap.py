"""Fully device-resident overlap detection: hash -> sort-join -> verify.

This is the hot path of the assembler (the reference's insertDataset +
insertAllEdgesOfRead probe loops, HashTable.cpp:50-104 and
OverlapGraph.cpp:529-565) re-designed as bulk device work.  Sorts and
scans stream through device memory, while per-probe binary searches would
be scattered dependent reads, so the engine is built around ONE relational
sort-merge join:

* reads are uploaded ONCE as 2-bit packed words; unpacked codes, reverse
  complements and window hashes are all derived on device in a single
  jitted setup program,
* the l-mer index is 4 keys/read -- prefix/suffix of forward/reverse
  strand (HashTable.cpp:88-104) -- stable-sorted so each hash bucket keeps
  the reference's (read id, orient) insertion order,
* the probe is a SORT-MERGE JOIN: all (read, position) query hashes and all
  index keys go through one stable sort (queries first among equal keys);
  prefix-sum scans then yield every query's bucket start (lower bound) and
  bucket size with zero per-query searches,
* hit queries are compacted to the front (second stable sort by query id),
  so the expansion buffers scale with hits, not with all n*npos probes,
* candidate expansion is one scatter + cummax; per-candidate state comes
  from three bulk gathers (bucket geometry, query id, packed index entry),
* overlap AND containment verification compare 2-bit packed words fetched
  with two row gathers; the in-row word extraction is a branchless select
  chain (no gather),
* survivors are compacted AND put in the reference's discovery order
  (read asc, position asc, bucket order) by one stable sort, then
  downloaded as a packed stream plus per-read counts,
* the production path is CANONICAL: only the smaller-endpoint occurrence
  of each overlap crosses the link (stream_canon; half the download), the
  native replay reconstructs the mirrors and per-read discovery order
  arithmetically (mg_build_stream_canon_words), and for mixed-length
  datasets the containment rule runs ON DEVICE as segment reductions over
  discovery order (_cont_canon) so contained hits never cross at all.
  A row-shard mode (row_lo) probes only reads [row_lo, n) against the
  full index — the hybrid engine's device shard.

Hash collisions are harmless: verification compares the full window
including the seed, so the accepted candidate set is exactly the
reference's.  Work is tiled into row chunks whose candidate totals fit a
fixed-capacity buffer, so each (queries, cap) tier compiles once.

meta layout (uint16): bits 0-1 edge orientation, bit 2 edge_ok,
bit 3 cont_ok, bits 4-15 overlap offset (lengths < 4096 enforced); the
canonical packed-u32 word is [r2 | meta-low-4 | offset:off_bits].
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .overlap import CandidateBatch

# numpy scalars on purpose: module-level jnp constants would initialize the
# XLA backend at import time (breaks jax.distributed.initialize ordering)
_B1 = np.uint32(0x01000193)     # FNV prime
_B2 = np.uint32(0x9E3779B1)     # golden-ratio odd constant
_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)

PAD_HASH = np.uint32(0xFFFFFFFF)


def _pow_u32(base: int, exp: int) -> int:
    return pow(base, exp, 1 << 32)


@partial(jax.jit, static_argnames=("hash_len",))
def window_hashes_u32(codes, hash_len):
    """[N, npos] uint32 window hashes: two polynomial hashes of every
    length-l window, mixed into one word.

    Each window is the static convolution
        w[j] = sum_{k<l} c[j+k] * B^(l-1-k)   (mod 2^32),
    evaluated by Horner's rule as l shifted-slice multiply-adds over the
    whole [N, npos] tile.  XLA fuses the chain into one loop fusion that
    reads the codes once and writes the hashes once.  Bit-identical to the
    rolling-prefix form window_hashes_scan (wrap-around uint32 arithmetic
    is a ring, so both sum the same terms)."""
    n, lmax = codes.shape
    l = hash_len
    npos = lmax - l + 1
    c = (codes.astype(jnp.uint32) & 3) + 1   # avoid zero-absorbing prefixes
    w1 = jnp.zeros((n, npos), jnp.uint32)
    w2 = jnp.zeros((n, npos), jnp.uint32)
    for k in range(l):
        t = c[:, k:k + npos]
        w1 = w1 * _B1 + t
        w2 = w2 * _B2 + t
    return w1 * _M1 ^ w2 * _M2


@partial(jax.jit, static_argnames=("hash_len",))
def window_hashes_scan(codes, hash_len):
    """[N, npos] uint32 window hashes via two rolling polynomial hashes:
    a lax.scan over the read length builds prefix hashes H[p], and each
    window is H[j+l] - H[j] * B^l.  The reference form that
    window_hashes_u32 is tested against."""
    n, lmax = codes.shape
    l = hash_len
    c = (codes.astype(jnp.uint32) & 3) + 1   # avoid zero-absorbing prefixes

    def roll(base):
        def step(carry, col):
            h = carry * base + col
            return h, h
        cols = jnp.transpose(c)              # [lmax, n]
        h0 = jnp.zeros((n,), jnp.uint32)
        _, hs = jax.lax.scan(step, h0, cols)
        # prefix hashes H[p] = hash of c[:, :p+1]; prepend zero row
        return jnp.concatenate([jnp.zeros((1, n), jnp.uint32), hs], axis=0)

    h1 = roll(_B1)                           # [lmax+1, n]
    h2 = roll(_B2)
    p1 = jnp.uint32(_pow_u32(0x01000193, l))
    p2 = jnp.uint32(_pow_u32(0x9E3779B1, l))
    npos = lmax - l + 1
    w1 = h1[l:l + npos] - h1[:npos] * p1     # [npos, n]
    w2 = h2[l:l + npos] - h2[:npos] * p2
    mixed = w1 * _M1 ^ w2 * _M2
    return jnp.transpose(mixed)              # [n, npos]


# --------------------------------------------------------------- bit packing

def pack_codes_host(codes):
    """2-bit pack [n, lmax] uint8 codes into [n, ceil(lmax/16)] uint32 words
    (LSB-first lanes).  Pad columns (PAD_CODE) pack as base 0 ('A'): the
    window hash maps both to the same symbol and verification masks to the
    compared length, so the padding value is immaterial.

    Byte-wise packing (4 codes per uint8, little-endian uint32 view) keeps
    every temporary uint8-sized — ~4x faster than the uint32 lane-shift
    formulation on large read sets."""
    n, lmax = codes.shape
    w = (lmax + 15) // 16
    c = np.zeros((n, 16 * w), np.uint8)
    np.bitwise_and(codes, 3, out=c[:, :lmax])
    b = c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    return np.ascontiguousarray(b).view(np.uint32)


@partial(jax.jit, static_argnames=("lmax",))
def _unpack_codes(words, lmax):
    """Inverse of pack_codes_host: [n, w] uint32 -> [n, lmax] uint8 in 0..3
    (padding positions read as 0)."""
    n, w = words.shape
    sh = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    lanes = (words[:, :, None] >> sh) & 3
    return lanes.reshape(n, 16 * w)[:, :lmax].astype(jnp.uint8)


@jax.jit
def _rc_codes(codes, lengths):
    """Reverse complement of uint8 code rows (positions >= length -> 0)."""
    lmax = codes.shape[1]
    k = jnp.arange(lmax)[None, :]
    src = jnp.clip(lengths[:, None] - 1 - k, 0, lmax - 1).astype(jnp.int32)
    g = jnp.take_along_axis(codes, src, axis=1)
    return jnp.where(k < lengths[:, None], 3 - g, 0).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("w",))
def _pack_codes_device(codes, w):
    n, lmax = codes.shape
    c = jnp.pad(codes.astype(jnp.uint32) & 3, ((0, 0), (0, 16 * w - lmax)))
    lanes = c.reshape(n, w, 16)
    sh = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    return (lanes << sh).sum(axis=2, dtype=np.uint32)


# ------------------------------------------------------------------- verify

def _extract_words(rows, s, w, qw_max):
    """16-base words of each row starting at base offset s (w words).

    rows is [C, >= qw_max+w+1] uint32; s the per-row base offset (0-based,
    s >> 4 <= qw_max).  The word-offset selection is a branchless select
    chain over the qw_max+1 possible word starts — a handful of vectorized
    selects over the already-fetched row instead of a per-element gather."""
    qw = (s >> 4).astype(jnp.int32)
    x = rows[:, 0:w + 1]
    for v in range(1, qw_max + 1):
        x = jnp.where((qw == v)[:, None], rows[:, v:v + w + 1], x)
    sh = ((s & 15) << 1).astype(jnp.uint32)[:, None]
    lo = x[:, :w]
    hi = x[:, 1:]
    spill = jnp.where(sh == 0, jnp.uint32(0),
                      hi << ((jnp.uint32(32) - sh) & jnp.uint32(31)))
    return (lo >> sh) | spill


def _verify_pairs(packed2, len1, len2, r1, j, r2, orient, hash_len, w,
                  qw_max, check_cont, rev_lmax=None):
    """Exact packed-word verification of candidate pairs: gathers the two
    packed rows from the combined fwd+rev matrix, then _verify_windows.

    rev_lmax selects the reverse-half layout: None means true
    reverse-complement rows (data at columns [0, len)); an integer means
    the FLIPPED-PADDED layout (3 - fwd[:, ::-1]: data at columns
    [lmax - len, lmax)) whose window starts shift by lmax - len2 — the
    flip avoids the per-row roll gather of _rc_codes on the setup path."""
    nrows = packed2.shape[0] // 2
    rows1 = packed2[r1]
    is_rev = orient > 1
    rows2 = packed2[jnp.where(is_rev, r2 + nrows, r2)]
    rev_shift = (None if rev_lmax is None
                 else jnp.where(is_rev, rev_lmax - len2, 0))
    return _verify_windows(rows1, rows2, len1, len2, j, orient, hash_len,
                           w, qw_max, check_cont, rev_shift)


def _verify_windows(rows1, rows2, len1, len2, j, orient, hash_len, w,
                    qw_max, check_cont, rev_shift=None):
    """Exact packed-word verification of candidate pairs.

    rows1/rows2 are the candidates' pre-fetched packed rows (rows2 already
    strand-resolved); the rest are per-candidate vectors.  rev_shift, when
    given, is added to every rows2 window start (the flipped-padded
    reverse layout of _verify_pairs).  Returns (edge_ok, cont_ok, eo,
    eoff).  Edge mode replicates checkOverlap (OverlapGraph.cpp:354-383,
    seed included so hash collisions are rejected); containment mode
    replicates checkOverlapForContainedRead (:302-340); orientation/offset
    derivation follows OverlapGraph.cpp:550-557."""
    l = hash_len
    is_pre = (orient == 0) | (orient == 2)
    wk16 = 16 * jnp.arange(w, dtype=jnp.int32)[None, :]
    if rev_shift is None:
        rev_shift = jnp.int32(0)

    def windows_equal(s1, s2, m):
        x = (_extract_words(rows1, s1, w, qw_max)
             ^ _extract_words(rows2, s2 + rev_shift, w, qw_max))
        nb = jnp.clip(m[:, None] - wk16, 0, 16)
        mask = jnp.where(
            nb >= 16, jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << (2 * nb).astype(jnp.uint32)) - jnp.uint32(1))
        return ((x & mask) == 0).all(axis=1)

    # edge mode (checkOverlap; seed included)
    ok_e = jnp.where(is_pre, len1 - j < len2, len2 - l >= j)
    s1_e = jnp.where(is_pre, j, 0)
    s2_e = jnp.clip(jnp.where(is_pre, 0, len2 - l - j), 0, None)
    m_e = jnp.where(ok_e, jnp.where(is_pre, len1 - j, j + l), 0)
    edge_ok = ok_e & windows_equal(s1_e, s2_e, m_e)

    if check_cont:
        # containment mode (checkOverlapForContainedRead); the len2 > l
        # guard is a no-op for real reads (QC enforces len > min_overlap)
        # but rejects zero-length dummy/padding rows exactly
        m2 = len2 - l
        ok_c = (jnp.where(is_pre, len1 - j - l >= m2, j >= m2)
                & (len1 > len2) & (len2 > l))
        s1_c = jnp.clip(jnp.where(is_pre, j, j - m2), 0, None)
        m_c = jnp.where(ok_c, len2, 0)
        cont_ok = ok_c & windows_equal(s1_c, jnp.zeros_like(s1_c), m_c)
    else:
        cont_ok = jnp.zeros_like(edge_ok)

    eo = jnp.where(orient == 0, 3,
         jnp.where(orient == 1, 0,
         jnp.where(orient == 2, 2, 1)))
    eoff = jnp.where(is_pre, j, len1 - l - j)
    return edge_ok, cont_ok, eo, eoff


def _expand_verify(packed2, lengths, left, counts, sorted_rid, sorted_orient,
                   row0, hash_len, cap, npos, w, wp, check_cont):
    """Shared expand + verify core (traced inside the sharded mesh kernel,
    parallel/sharded.py).

    left/counts are the probe results for a flat local query block whose
    first query is position 0 of global read row `row0`; sorted_rid/orient
    may be a key-range shard of the index (left indexes into them).
    Returns per-slot (keep, r1, r2, qidx, fe, eoff) with qidx the LOCAL
    query index of each candidate.
    """
    nq = left.shape[0]

    # ---- expansion: scatter each probe's first slot, fill with cummax ----
    cum = jnp.cumsum(counts, dtype=jnp.int32)
    total = cum[-1]
    starts = cum - counts
    qi = jnp.arange(nq, dtype=jnp.int32)
    dest = jnp.where(counts > 0, starts, cap)
    seed = jnp.zeros((cap,), jnp.int32).at[dest].max(qi, mode="drop")
    qidx = jax.lax.cummax(seed)
    k = jnp.arange(cap, dtype=jnp.int32)
    in_range = k < total
    within = k - starts[qidx]
    src = jnp.clip(left[qidx] + within, 0, sorted_rid.shape[0] - 1)
    r2 = sorted_rid[src]
    orient = sorted_orient[src]
    r1 = row0 + qidx // npos
    j = qidx - (qidx // npos) * npos

    len1 = lengths[r1]
    len2 = lengths[r2]
    edge_ok, cont_ok, eo, eoff = _verify_pairs(
        packed2, len1, len2, r1, j, r2, orient, hash_len, w, wp - w - 1,
        check_cont)
    fe = (eo | (edge_ok.astype(jnp.int32) << 2)
          | (cont_ok.astype(jnp.int32) << 3))
    keep = in_range & (edge_ok | cont_ok)
    return keep, r1, r2, qidx, fe, eoff


# ----------------------------------------------------------------- pipeline

_SETUP_STATIC = ("hash_len", "w", "wp", "lmax")


def setup_program(pf, lengths, hash_len, w, wp, lmax,
                  window_hashes=window_hashes_u32):
    """Derive everything from the HOST-packed forward word matrix in ONE
    program: unpacked fwd/rev codes, 2-bit packed rows (fwd then rev,
    spill-padded to wp), forward window hashes, and the stable-sorted
    4-key index with (rid<<2|orient) packed entry words
    (HashTable.cpp:88-104 key set, bucket (rid, orient) order).

    The upload is the packed words (4x fewer bytes than raw uint8 codes);
    pack_codes_host and _pack_codes_device produce identical layouts, so
    pf doubles as the forward half of the verification row store.
    _setup_kernel is this program jitted with the production window hash;
    window_hashes is a parameter so that other hash forms can be timed
    inside the same program."""
    codes_fwd = _unpack_codes(pf, lmax)
    # reverse strand in FLIPPED-PADDED layout: 3 - fwd[:, ::-1] IS the
    # reverse complement, shifted right so row data occupies columns
    # [lmax - len, lmax).  A static flip replaces the per-row roll gather
    # of _rc_codes (one gathered element per base); verification
    # compensates by adding lmax - len2 to reverse-row window starts
    # (_verify_pairs rev_lmax) and the reverse hash keys read at shifted
    # columns below.  Front padding flips to 3s, which no in-range window
    # ever reads.
    flipped = (3 - codes_fwd[:, ::-1]).astype(jnp.uint8)
    pr = _pack_codes_device(flipped, w)
    pad = ((0, 0), (0, wp - w))
    packed2 = jnp.concatenate([jnp.pad(pf, pad), jnp.pad(pr, pad)], axis=0)

    hf = window_hashes(codes_fwd, hash_len)
    hr = window_hashes(flipped, hash_len)

    n = hf.shape[0] - 1                      # row 0 is the unused dummy
    suf = (lengths[1:] - hash_len).astype(jnp.int32)
    k0 = hf[1:, 0]
    k1 = jnp.take_along_axis(hf[1:], suf[:, None], axis=1)[:, 0]
    # flipped layout: the RC prefix window sits at column lmax - len, the
    # RC suffix window at the (static) last column lmax - hash_len
    k2 = jnp.take_along_axis(hr[1:], (lmax - lengths[1:])[:, None]
                             .astype(jnp.int32), axis=1)[:, 0]
    k3 = hr[1:, lmax - hash_len]
    keys = jnp.stack([k0, k1, k2, k3], axis=1).reshape(-1)
    rid = jnp.repeat(jnp.arange(1, n + 1, dtype=jnp.uint32), 4)
    orient = jnp.tile(jnp.arange(4, dtype=jnp.uint32), n)
    sk, sid = jax.lax.sort((keys, (rid << 2) | orient), num_keys=1,
                           is_stable=True)
    return packed2, hf, sk, sid


_setup_kernel = jax.jit(setup_program, static_argnames=_SETUP_STATIC)


@partial(jax.jit, static_argnames=("hash_len", "sum_block"))
def _probe_join(hf, lengths, sk, hash_len, sum_block):
    """Sort-merge join of every (read, position) query hash against the
    sorted index keys — the device replacement for the reference's
    per-window hash-table probes (HashTable.cpp:202-221).

    One stable sort puts queries before the index entries that share their
    key, so prefix-sum scans give each query its bucket's lower bound and
    size; a second stable sort compacts hit queries to the front in query
    id (read, position) order.  Returns (rk, rleft, rcnt) — hit query ids
    with bucket geometry, sentinel-padded — plus the hit total and blocked
    partial candidate sums (summed exactly on the host in int64).
    """
    n1, npos = hf.shape
    q_total = n1 * npos
    m = sk.shape[0]
    l = hash_len
    q = hf.reshape(-1)
    jj = jnp.arange(npos, dtype=jnp.int32)[None, :]
    valid = ((jj >= 1) & (jj < (lengths[:, None] - l))).reshape(-1)

    # payload: bit31 = index entry, bit30 = invalid query, low bits = id
    qid = jnp.arange(q_total, dtype=jnp.uint32)
    pq = qid | jnp.where(valid, jnp.uint32(0), jnp.uint32(0x40000000))
    pi = jnp.uint32(0x80000000) | jnp.arange(m, dtype=jnp.uint32)
    kv, pv = jax.lax.sort(
        (jnp.concatenate([q, sk]), jnp.concatenate([pq, pi])),
        num_keys=1, is_stable=True)

    tag = (pv >> 31).astype(jnp.int32)
    u = jnp.cumsum(tag, dtype=jnp.int32)
    # at a query position u counts index entries with key < q (equal-key
    # entries sort after queries by stability) => u = lower_bound
    left = u
    is_last = jnp.concatenate(
        [kv[1:] != kv[:-1], jnp.ones((1,), bool)])
    ub = jnp.flip(jax.lax.cummin(jnp.flip(
        jnp.where(is_last, u, jnp.int32(0x7FFFFFFF)))))
    cnt = ub - left                          # bucket size at query positions

    is_query = tag == 0
    hit = is_query & (cnt > 0) & ((pv & jnp.uint32(0x40000000)) == 0)
    rkey = jnp.where(hit, pv & jnp.uint32(0x3FFFFFFF),
                     jnp.uint32(0xFFFFFFFF))
    rk, rleft, rcnt = jax.lax.sort((rkey, left, cnt), num_keys=1,
                                   is_stable=True)
    h_total = hit.sum(dtype=jnp.int32)

    # exact grand total without int32 overflow: blocked partial sums,
    # finished on the host in int64 (block size chosen so each partial
    # sum stays < 2^31 even when every query hits the largest bucket)
    cq = jnp.where(hit, cnt, 0)
    v = cq.shape[0]
    vp = -v % sum_block
    parts = jnp.pad(cq, (0, vp)).reshape(-1, sum_block).sum(
        axis=1, dtype=jnp.int32)
    return rk, rleft, rcnt, h_total, parts


@partial(jax.jit, static_argnames=("n1", "npos"))
def _row_stats(rk, rcnt, h_total, n1, npos):
    """Per-read candidate totals and hit-query counts (multi-chunk planning
    only — the single-chunk fast path never pays these scatter-adds)."""
    v = rk.shape[0]
    isq = jnp.arange(v, dtype=jnp.int32) < h_total
    row = jnp.where(isq, (rk // jnp.uint32(npos)).astype(jnp.int32), n1)
    row_tot = jnp.zeros((n1,), jnp.int32).at[row].add(
        jnp.where(isq, rcnt, 0), mode="drop")
    row_hits = jnp.zeros((n1,), jnp.int32).at[row].add(
        jnp.where(isq, 1, 0), mode="drop")
    return row_tot, row_hits


@partial(jax.jit, static_argnames=(
    "hash_len", "nqt", "cap", "npos", "w", "qw_max", "check_cont",
    "off_bits", "uniform_len", "dedup"))
def _emit2(packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0, nh_real,
           row0, hash_len, nqt, cap, npos, w, qw_max, check_cont, off_bits,
           uniform_len, dedup=False):
    """Expand + verify + order one chunk of hit queries [h0, h0+nh_real).

    nqt is the static tier size of the slice; nh_real (dynamic scalar) is
    the chunk's true hit count — counts beyond it are zeroed so the
    tier-rounded window never double-emits the next chunk's rows.  The
    survivor buffer comes back compacted to the front AND in the
    reference's discovery order (query id asc, bucket order) from one
    stable sort.
    """
    n1 = lengths.shape[0]
    qid_s = jax.lax.dynamic_slice(rk_pad, (h0,), (nqt,))
    left_s = jax.lax.dynamic_slice(rleft_pad, (h0,), (nqt,))
    cnt_s = jax.lax.dynamic_slice(rcnt_pad, (h0,), (nqt,))
    live = jnp.arange(nqt, dtype=jnp.int32) < nh_real
    cnt_s = jnp.where(live, cnt_s, 0)

    cum = jnp.cumsum(cnt_s, dtype=jnp.int32)
    total = cum[-1]
    starts = cum - cnt_s
    hdest = jnp.where(cnt_s > 0, starts, cap)
    seed = jnp.zeros((cap,), jnp.int32).at[hdest].max(
        jnp.arange(nqt, dtype=jnp.int32), mode="drop")
    hidx = jax.lax.cummax(seed)
    k = jnp.arange(cap, dtype=jnp.int32)
    in_range = k < total

    dsh = left_s - starts                    # src = slot + (left - start)
    src = k + dsh[hidx]
    qid = (qid_s[hidx] & jnp.uint32(0x3FFFFFFF)).astype(jnp.int32)
    e = sid[jnp.clip(src, 0, sid.shape[0] - 1)]
    r2 = (e >> 2).astype(jnp.int32)
    orient = (e & 3).astype(jnp.int32)
    qloc = qid // npos
    j = qid - qloc * npos
    r1 = row0 + qloc           # probe rows may be a shard [row0, n)
    r1c = jnp.clip(r1, 0, n1 - 1)

    if uniform_len >= 0:
        len1 = jnp.int32(uniform_len)
        len2 = jnp.broadcast_to(jnp.int32(uniform_len), (cap,))
    else:
        len1 = lengths[r1c]
        len2 = lengths[r2]

    edge_ok, cont_ok, eo, eoff = _verify_pairs(
        packed2, len1, len2, r1c, j, r2, orient, hash_len, w, qw_max,
        check_cont, rev_lmax=npos + hash_len - 1)
    if dedup and check_cont:
        # hybrid mixed mode: canonical edges (smaller endpoint) PLUS every
        # containment hit (either id order — the container is the longer
        # read); the host resolves supers globally across shards and masks
        # the edge records afterwards
        keep = in_range & ((edge_ok & (r1c <= r2)) | cont_ok)
    elif dedup:
        # canonical-dedup mode (uniform lengths, no containment): keep each
        # overlap's smaller-endpoint occurrence only; the native replay
        # reconstructs the mirrors (mg_build_stream_canon)
        keep = in_range & edge_ok & (r1c <= r2)
    else:
        keep = in_range & (edge_ok | cont_ok)
    fe = (eo | (edge_ok.astype(jnp.int32) << 2)
          | (cont_ok.astype(jnp.int32) << 3))
    n_keep = keep.sum(dtype=jnp.int32)
    keep_counts = jnp.zeros((n1,), jnp.int32).at[r1c].add(
        keep.astype(jnp.int32), mode="drop")

    # compaction + final order in one stable sort: survivors first, and the
    # slot order (qid asc, bucket position asc) is preserved for equal keys
    skey = 1 - keep.astype(jnp.uint32)
    if off_bits >= 0:
        # single uint32 word per survivor: [r2 | fe:4 | eoff:off_bits]
        word = ((r2.astype(jnp.uint32) << (4 + off_bits))
                | (fe.astype(jnp.uint32) << off_bits)
                | jnp.clip(eoff, 0, (1 << off_bits) - 1).astype(jnp.uint32))
        _, out = jax.lax.sort((skey, word), num_keys=1, is_stable=True)
        return out, keep_counts, n_keep
    meta = (fe | (eoff << 4)).astype(jnp.uint16)
    _, r2_out, meta_out = jax.lax.sort((skey, r2, meta), num_keys=1,
                                       is_stable=True)
    return (r2_out, meta_out), keep_counts, n_keep


@partial(jax.jit, static_argnames=("n1", "off_bits"))
def _cont_canon(out, kc, n_keep, lengths, n1, off_bits):
    """On-device containment resolution + canonical edge filter over one
    survivor buffer (single-chunk mixed-length datasets).

    Replays the reference's containment rule on device
    (OverlapGraph.cpp:225-290 via the stream replay semantics: first
    containing read wins, a strictly longer one replaces) as a pair of
    segment reductions over discovery order: the winner for a contained
    read is the FIRST hit whose container length equals the segment
    maximum.  Then filters edge records to non-contained endpoints and
    the canonical (smaller-endpoint) occurrence, compacting with one
    stable sort.  Returns (words2, counts2, n_keep2, supers, firsthit_r1)
    — firsthit_r1 feeds the per-1e6 contained-read heartbeat log lines.
    """
    cap = out.shape[0]
    k = jnp.arange(cap, dtype=jnp.int32)
    live = k < n_keep
    # recover each slot's source read: scatter read starts, fill with cummax
    cum = jnp.cumsum(kc, dtype=jnp.int32)
    starts = cum - kc
    ridx = jnp.arange(n1, dtype=jnp.int32)
    dest = jnp.where(kc > 0, starts, cap)
    seed = jnp.zeros((cap,), jnp.int32).at[dest].max(ridx, mode="drop")
    r1 = jax.lax.cummax(seed)

    ob = off_bits
    r2 = (out >> jnp.uint32(4 + ob)).astype(jnp.int32)
    fe = ((out >> jnp.uint32(ob)) & jnp.uint32(15)).astype(jnp.int32)
    cont = live & ((fe & 8) != 0)
    edge = live & ((fe & 4) != 0)
    len1 = lengths[r1]
    r2c = jnp.clip(r2, 0, n1 - 1)

    big = jnp.int32(cap)
    seg = jnp.where(cont, r2c, n1)            # n1 is out of range -> dropped
    maxlen = jnp.zeros((n1,), jnp.int32).at[seg].max(len1, mode="drop")
    is_max = cont & (len1 == maxlen[r2c])
    winner = jnp.full((n1,), big, jnp.int32).at[
        jnp.where(is_max, r2c, n1)].min(k, mode="drop")
    first = jnp.full((n1,), big, jnp.int32).at[seg].min(k, mode="drop")
    winner_r1 = r1[jnp.clip(winner, 0, cap - 1)]
    supers = jnp.where(winner < big, winner_r1, 0)
    firsthit = jnp.where(first < big, r1[jnp.clip(first, 0, cap - 1)], 0)

    keep2 = (edge & (supers[r1] == 0) & (supers[r2c] == 0) & (r1 <= r2))
    counts2 = jnp.zeros((n1,), jnp.int32).at[
        jnp.where(keep2, r1, n1)].add(1, mode="drop")
    n_keep2 = keep2.sum(dtype=jnp.int32)
    skey = 1 - keep2.astype(jnp.uint32)
    _, words2 = jax.lax.sort((skey, out), num_keys=1, is_stable=True)
    return words2, counts2, n_keep2, supers, firsthit


def canon_off_bits(n_unique, lmax, min_overlap):
    """Packed-word offset width shared by the device pipeline and the
    native canonical scan, or -1 when the single-u32 layout doesn't fit."""
    bits_r2 = max(1, n_unique.bit_length())
    bits_off = max(1, (lmax - min_overlap + 1).bit_length())
    return bits_off if bits_r2 + 4 + bits_off <= 32 else -1


def _tier(x, lo=1 << 16):
    """Smallest of {2^k, 3*2^(k-1)} >= x: bounds compile tiers to ~2/octave."""
    t = lo
    while t < x:
        t2 = t + (t >> 1)
        if t2 >= x:
            return t2
        t *= 2
    return t


class DeviceOverlapPipeline:
    """Host orchestration of the device overlap pipeline.

    Produces the packed survivor stream consumed by the native threaded
    replay (graph/build.py build_from_pipeline): per-read counts, r2 ids and
    uint16 meta words in reference discovery order.
    """

    MAX_CAP = 1 << 23      # upper bound on a chunk's candidate buffer

    def __init__(self, dataset, min_overlap, chunk_rows=None, row_lo=0):
        self.ds = dataset
        self.hash_len = min_overlap - 1
        # probe only reads >= row_lo (the hybrid engine's device shard);
        # the index still covers ALL reads, so cross-shard overlaps are
        # discovered from whichever endpoint lies in this shard
        self.row0 = int(row_lo)
        ds = dataset
        lmax = ds.codes_fwd.shape[1]
        if lmax >= 4096:
            raise ValueError("read length >= 4096 unsupported by meta packing")
        self.lmax = lmax
        self.w = (lmax + 15) // 16
        # spill-padded row width: word extraction reads words
        # [s>>4, s>>4 + w] with s <= lmax - hash_len
        self.qw_max = (lmax - self.hash_len) >> 4
        self.wp = self.qw_max + self.w + 1
        n1 = ds.codes_fwd.shape[0]
        self.npos = lmax - self.hash_len + 1
        if n1 * self.npos >= 1 << 30:
            raise ValueError(
                "query id space exceeds 2^30 (%d reads x %d positions); "
                "use the sharded pipeline" % (n1, self.npos))
        self.lengths = jnp.asarray(ds.lengths.astype(np.int32))

        pf = jnp.asarray(pack_codes_host(ds.codes_fwd))  # the ONE upload
        self.packed2, self.hf, self.sk, self.sid = _setup_kernel(
            pf, self.lengths, self.hash_len, self.w, self.wp, lmax)

        # probe join; the blocked partial sums keep every device-side
        # accumulator < 2^31 even for pathologically repetitive inputs
        m = int(self.sk.shape[0])
        sum_block = 1 << max(3, min(12, (1 << 31).bit_length()
                                    - max(m, 1).bit_length() - 2))
        hf_probe = self.hf[self.row0:] if self.row0 else self.hf
        len_probe = (self.lengths[self.row0:] if self.row0
                     else self.lengths)
        self.rk, self.rleft, self.rcnt, h_total, parts = _probe_join(
            hf_probe, len_probe, self.sk, self.hash_len, sum_block)
        self.h_total = int(h_total)
        self.grand = int(np.asarray(parts).sum(dtype=np.int64))

        # survivor packing: one uint32 word per survivor when
        # (r2 bits + 4 flag/orient bits + offset bits) fit, else the
        # (r2 int32, meta uint16) pair — 6 bytes.  The packed word layout is
        # [r2 | edge_ok/cont_ok/eo (4b) | eoff (off_bits)].
        self.off_bits = canon_off_bits(n1 - 1, lmax, min_overlap)
        lens = ds.lengths[1:]
        self.uniform_len = (int(lens[0])
                            if len(lens) and (lens == lens[0]).all() else -1)

    def _plan_chunks(self, chunk_cap=None):
        """Chunk plan (cap, nqt, chunks) with chunks = [(hit offset, hit
        count)]; every chunk's candidate total fits cap."""
        npos = self.npos
        n1 = self.hf.shape[0]
        grand, h_total = self.grand, self.h_total
        limit = min(chunk_cap or self.MAX_CAP, self.MAX_CAP)
        if grand <= limit:
            return (_tier(max(grand, 1)), _tier(max(h_total, 1)),
                    [(0, h_total)])
        row_tot, row_hits = _row_stats(self.rk, self.rcnt,
                                       np.int32(h_total), n1, npos)
        row_tot = np.asarray(row_tot).astype(np.int64)
        row_hits = np.asarray(row_hits).astype(np.int64)
        cap = min(_tier(max(grand, 1)), limit)
        cap = max(cap, int(row_tot.max()))
        cum = np.concatenate([[0], np.cumsum(row_tot)])
        bounds = [0]
        while bounds[-1] < n1:
            b = int(np.searchsorted(cum, cum[bounds[-1]] + cap,
                                    side="right")) - 1
            b = max(b, bounds[-1] + 1)
            bounds.append(min(b, n1))
        hoff = np.concatenate([[0], np.cumsum(row_hits)])
        chunks = []
        for i in range(len(bounds) - 1):
            assert int(row_tot[bounds[i]:bounds[i + 1]].sum()) <= cap
            chunks.append((int(hoff[bounds[i]]),
                           int(hoff[bounds[i + 1]] - hoff[bounds[i]])))
        nqt = _tier(max(max(c[1] for c in chunks), 1))
        return cap, nqt, chunks

    def _padded(self, nqt):
        """Sentinel-pad the probe arrays once so every chunk's static-size
        dynamic_slice stays in bounds without clamping."""
        if getattr(self, "_pad_cache", None) is None or \
                self._pad_cache[0] < nqt:
            self._pad_cache = (nqt, (
                jnp.concatenate(
                    [self.rk, jnp.full((nqt,), PAD_HASH, jnp.uint32)]),
                jnp.concatenate(
                    [self.rleft, jnp.zeros((nqt,), jnp.int32)]),
                jnp.concatenate(
                    [self.rcnt, jnp.zeros((nqt,), jnp.int32)])))
        return self._pad_cache[1]

    def stream(self, check_cont=True, download=True):
        """Survivor stream in reference discovery order (read asc, j asc,
        bucket order): (counts [n+1] int64, r2 int32, meta uint16).

        download=False executes the full device pipeline (probe + expand +
        verify + compact) but skips the bulk host transfers, forcing each
        chunk only through its n_keep scalar — the device-compute-only
        measurement mode (bench.py)."""
        npos = self.npos
        n1 = self.hf.shape[0]
        cap, nqt, chunks = self._plan_chunks()
        rk_pad, rleft_pad, rcnt_pad = self._padded(nqt)

        # dispatch every chunk (async), device-accumulate the per-read
        # survivor counts, then fetch: all n_keep scalars in one sweep,
        # tier-sliced survivor buffers through a small thread pool, counts
        # once.
        outs = []
        kc_total = None
        for h0, nh in chunks:
            out, kc, n_keep = _emit2(
                self.packed2, self.lengths, rk_pad, rleft_pad, rcnt_pad,
                self.sid, np.int32(h0), np.int32(nh), np.int32(self.row0),
                self.hash_len, nqt, cap, npos, self.w, self.qw_max,
                check_cont, self.off_bits, self.uniform_len)
            outs.append((out, n_keep))
            kc_total = kc if kc_total is None else kc_total + kc

        n_keeps = [int(nk) for _, nk in outs]
        if not download:
            return None
        slices = []
        for (out, _), nk in zip(outs, n_keeps):
            if nk == 0:
                continue
            if self.off_bits >= 0:
                sl = min(_tier(nk, lo=1 << 12), out.shape[0])
                slices.append((out[:sl], nk))
            else:
                sl = min(_tier(nk, lo=1 << 12), out[0].shape[0])
                slices.append(((out[0][:sl], out[1][:sl]), nk))

        import concurrent.futures as cf
        def fetch(item):
            buf, nk = item
            if self.off_bits >= 0:
                return np.asarray(buf)[:nk]
            return np.asarray(buf[0])[:nk], np.asarray(buf[1])[:nk]
        if len(slices) > 1:
            with cf.ThreadPoolExecutor(min(4, len(slices))) as ex:
                parts = list(ex.map(fetch, slices))
        else:
            parts = [fetch(s) for s in slices]
        keep_counts = np.asarray(kc_total).astype(np.int64)

        if self.off_bits >= 0:
            packed = (np.concatenate(parts) if parts
                      else np.zeros(0, np.uint32))
            ob = self.off_bits
            r2 = (packed >> np.uint32(4 + ob)).astype(np.int32)
            meta = ((((packed >> np.uint32(ob)) & np.uint32(15))
                     | ((packed & np.uint32((1 << ob) - 1)) << np.uint32(4)))
                    .astype(np.uint16))
        elif parts:
            r2 = np.concatenate([p[0] for p in parts])
            meta = np.concatenate([p[1] for p in parts])
        else:
            r2 = np.zeros(0, np.int32)
            meta = np.zeros(0, np.uint16)
        return keep_counts, r2, meta

    def _fetch_packed(self, bufs_nk):
        """Fetch packed-u32 device buffers: each (buf, nk) tier-sliced and
        split into sub-slices fetched concurrently by a small thread
        pool."""
        import concurrent.futures as cf
        views = []                            # per input: list of sub-views
        for buf, nk in bufs_nk:
            if nk == 0:
                views.append([])
                continue
            sl = min(_tier(nk, lo=1 << 12), buf.shape[0])
            parts = 4 if sl >= 1 << 20 else (2 if sl >= 1 << 16 else 1)
            step = -(-sl // parts)
            views.append([buf[a:min(a + step, sl)]
                          for a in range(0, sl, step)])
        flat = [v for row in views for v in row]
        if len(flat) > 1:
            with cf.ThreadPoolExecutor(min(8, len(flat))) as ex:
                fetched = list(ex.map(np.asarray, flat))
        else:
            fetched = [np.asarray(v) for v in flat]
        out = []
        i = 0
        for row, (_, nk) in zip(views, bufs_nk):
            if not row:
                out.append(np.zeros(0, np.uint32))
                continue
            got = (np.concatenate(fetched[i:i + len(row)])
                   if len(row) > 1 else fetched[i])
            i += len(row)
            out.append(got[:nk])
        return out

    def _unpack_words(self, packed):
        ob = self.off_bits
        r2 = (packed >> np.uint32(4 + ob)).astype(np.int32)
        meta = ((((packed >> np.uint32(ob)) & np.uint32(15))
                 | ((packed & np.uint32((1 << ob) - 1)) << np.uint32(4)))
                .astype(np.uint16))
        return r2, meta

    def stream_canon(self, check_cont=True):
        """Canonical (deduplicated) survivor stream for the native replay:
        one record per physical overlap, from its smaller endpoint;
        containment resolved ON DEVICE.

        Returns (counts int64, packed uint32 words, supers, firsthit) —
        words decode via off_bits as [r2 | flags:4 | offset:off_bits]
        (mg_build_stream_canon_words / _unpack_words); supers/firsthit are
        None for uniform-length datasets.  Returns None when the canonical
        path is unsupported (no packed-word layout, or a mixed-length
        dataset whose candidate total needs multiple chunks).
        """
        if self.off_bits < 0:
            return None
        n1 = self.hf.shape[0]
        npos = self.npos

        if check_cont:
            cap, nqt, chunks = self._plan_chunks()
            if len(chunks) > 1:
                return None                   # containment is global; the
                                              # full-stream path handles it
            rk_pad, rleft_pad, rcnt_pad = self._padded(nqt)
            h0, nh = chunks[0]
            out, kc, n_keep = _emit2(
                self.packed2, self.lengths, rk_pad, rleft_pad, rcnt_pad,
                self.sid, np.int32(h0), np.int32(nh), np.int32(self.row0),
                self.hash_len, nqt, cap, npos, self.w, self.qw_max, True,
                self.off_bits, self.uniform_len)
            words2, counts2, n_keep2, sup, fh = _cont_canon(
                out, kc, n_keep, self.lengths, n1, self.off_bits)
            nk = int(n_keep2)
            packed = (self._fetch_packed([(words2, nk)])[0] if nk
                      else np.zeros(0, np.uint32))
            counts = np.asarray(counts2).astype(np.int64)
            supers = np.asarray(sup).astype(np.int64)
            firsthit = np.asarray(fh)
        else:
            # single chunk whenever the candidate buffer fits: chunk
            # planning needs per-row stats (a device pass + download), and
            # the in-order device queue serializes chunk fetches after all
            # emits anyway, so chunking buys nothing here
            cap, nqt, chunks = self._plan_chunks()
            rk_pad, rleft_pad, rcnt_pad = self._padded(nqt)
            outs = []
            kc_total = None
            for h0, nh in chunks:             # dispatch everything (async)
                out, kc, n_keep = _emit2(
                    self.packed2, self.lengths, rk_pad, rleft_pad, rcnt_pad,
                    self.sid, np.int32(h0), np.int32(nh),
                    np.int32(self.row0), self.hash_len, nqt, cap, npos,
                    self.w, self.qw_max, False, self.off_bits,
                    self.uniform_len, dedup=True)
                outs.append((out, n_keep))
                kc_total = kc if kc_total is None else kc_total + kc
            bufs_nk = [(out, int(nk)) for out, nk in outs]
            parts = self._fetch_packed(bufs_nk)
            packed = (np.concatenate(parts) if len(parts) > 1
                      else (parts[0] if parts else np.zeros(0, np.uint32)))
            counts = np.asarray(kc_total).astype(np.int64)
            supers = None
            firsthit = None
        return counts, packed, supers, firsthit

    def stream_canon_raw_mixed(self):
        """Hybrid mixed-mode stream: canonical edge records (smaller
        endpoint, UNFILTERED by containment) plus every containment hit,
        as packed words carrying their fe flags (bit 2 edge, bit 3 cont).
        The caller resolves supers globally across shards and masks the
        edge records.  Returns (counts int64, words uint32) or None."""
        if self.off_bits < 0:
            return None
        npos = self.npos
        cap, nqt, chunks = self._plan_chunks()
        rk_pad, rleft_pad, rcnt_pad = self._padded(nqt)
        outs = []
        kc_total = None
        for h0, nh in chunks:
            out, kc, n_keep = _emit2(
                self.packed2, self.lengths, rk_pad, rleft_pad, rcnt_pad,
                self.sid, np.int32(h0), np.int32(nh), np.int32(self.row0),
                self.hash_len, nqt, cap, npos, self.w, self.qw_max, True,
                self.off_bits, self.uniform_len, dedup=True)
            outs.append((out, n_keep))
            kc_total = kc if kc_total is None else kc_total + kc
        bufs_nk = [(out, int(nk)) for out, nk in outs]
        parts = self._fetch_packed(bufs_nk)
        packed = (np.concatenate(parts) if len(parts) > 1
                  else (parts[0] if parts else np.zeros(0, np.uint32)))
        counts = np.asarray(kc_total).astype(np.int64)
        return counts, packed

    def candidates(self, check_cont=True):
        """Back-compat view of stream(): (CandidateBatch, edge_orient,
        edge_offset, edge_ok, cont_ok) with j unset (the downstream replay
        never uses j; offsets are derived in-kernel)."""
        counts, r2, meta = self.stream(check_cont)
        r1 = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        eo = (meta & 3).astype(np.int64)
        edge_ok = ((meta >> 2) & 1).astype(bool)
        cont_ok = ((meta >> 3) & 1).astype(bool)
        eoff = (meta >> 4).astype(np.int64)
        batch = CandidateBatch(
            r1=r1, j=np.zeros_like(r1),
            r2=r2.astype(np.int64), orient=np.zeros(len(r1), np.uint8))
        return batch, eo, eoff, edge_ok, cont_ok
