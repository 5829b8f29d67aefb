"""Unit tests for the device kernels against brute-force host references."""

import numpy as np
import pytest

from metagenomics_tpu.ops import packing
from metagenomics_tpu.ops.overlap import CandidateBatch, verify_candidates
from metagenomics_tpu.dataset import reverse_complement_str


def _random_reads(rng, n, lmin, lmax):
    reads = []
    for _ in range(n):
        ln = rng.integers(lmin, lmax + 1)
        reads.append("".join(rng.choice(list("ACGT"), ln)))
    return reads


def _pad(reads):
    lmax = max(len(r) for r in reads)
    arr = np.zeros((len(reads), lmax), dtype=np.uint8)
    lens = np.array([len(r) for r in reads])
    for i, r in enumerate(reads):
        arr[i, :len(r)] = np.frombuffer(r.encode(), dtype=np.uint8)
    return packing.ascii_to_codes(arr, lens), lens


def test_reverse_complement_matches_host():
    rng = np.random.default_rng(0)
    reads = _random_reads(rng, 50, 5, 60)
    codes, lens = _pad(reads)
    rc = np.asarray(packing.reverse_complement_codes(codes, lens))
    for i, r in enumerate(reads):
        got = packing.codes_to_ascii(rc[i], len(r)).decode()
        assert got == reverse_complement_str(r)


def test_canonicalize_is_lexicographic_min():
    rng = np.random.default_rng(1)
    reads = _random_reads(rng, 100, 4, 40)
    codes, lens = _pad(reads)
    canon, was_rev = packing.canonicalize_codes(codes, lens)
    canon = np.asarray(canon)
    for i, r in enumerate(reads):
        rc = reverse_complement_str(r)
        expect = r if r < rc else rc
        got = packing.codes_to_ascii(canon[i], len(r)).decode()
        assert got == expect


def test_qc_mask_matches_reference_rules():
    reads = ["ACGTACGTACGT", "AAAAAAAAAACG", "ACGTNACGTACG", "ACGT",
             "AAAAAAACGTAC"]
    codes, lens = _pad(reads)
    mask = np.asarray(packing.qc_mask(codes, lens, 5))
    # read 0: fine; read 1: 10 A of 12 >= trunc(9.6)=9 -> bad; read 2: N -> bad
    # read 3: length 4 <= 5 -> bad; read 4: 7 A of 12 < 9 -> good
    assert mask.tolist() == [True, False, False, False, True]


def test_pack_sort_limbs_orders_like_strings():
    rng = np.random.default_rng(2)
    reads = _random_reads(rng, 200, 3, 30)
    codes, lens = _pad(reads)
    limbs = packing.pack_sort_limbs(codes, lens)
    order = np.lexsort(tuple(limbs[:, k] for k in range(limbs.shape[1] - 1, -1, -1)))
    got = [reads[i] for i in order]
    assert got == sorted(reads)


def test_verify_candidates_edge_mode_brute_force():
    rng = np.random.default_rng(3)
    reads = [""] + _random_reads(rng, 30, 20, 40)  # 1-indexed
    codes, lens = _pad(reads)
    rev = np.asarray(packing.reverse_complement_codes(codes, lens))
    l = 7
    r1s, js, r2s, orients, expect = [], [], [], [], []
    for r1 in range(1, len(reads)):
        s1 = reads[r1]
        for j in range(1, len(s1) - l):
            for r2 in range(1, len(reads)):
                s2f = reads[r2]
                s2r = reverse_complement_str(s2f)
                for orient in range(4):
                    s2 = s2f if orient <= 1 else s2r
                    if orient in (0, 2):
                        seed = s1[j:j + l] == s2[:l]
                        ok = (seed and len(s1) - j < len(s2)
                              and s1[j + l:] == s2[l:l + len(s1) - j - l])
                    else:
                        seed = s1[j:j + l] == s2[len(s2) - l:]
                        ok = (seed and len(s2) - l >= j
                              and s1[:j] == s2[len(s2) - l - j:len(s2) - l])
                    if not seed and (r1 + j + r2) % 7:
                        continue    # keep batch small; sample non-seed cases
                    r1s.append(r1)
                    js.append(j)
                    r2s.append(r2)
                    orients.append(orient)
                    expect.append(ok)
    batch = CandidateBatch(np.array(r1s), np.array(js), np.array(r2s),
                           np.array(orients, dtype=np.uint8))
    got = verify_candidates(codes, rev, lens, batch, l, mode="edge")
    assert got.tolist() == expect


def test_mincostflow_simple():
    from metagenomics_tpu.mincostflow import solve_min_cost_flow
    # diamond: 1->2->4 cheap, 1->3->4 expensive, need 2 units 1->4
    arcs = [
        (4, 1, 2, 2, 0),          # return arc forces 2 units of circulation
        (1, 2, 0, 1, 1), (2, 4, 0, 1, 1),
        (1, 3, 0, 5, 10), (3, 4, 0, 5, 10),
    ]
    flows = solve_min_cost_flow(4, arcs)
    assert flows == [2, 1, 1, 1, 1]


def test_mincostflow_lower_bound_forcing():
    from metagenomics_tpu.mincostflow import solve_min_cost_flow
    arcs = [
        (3, 1, 1, 10, 100),       # return
        (1, 2, 1, 1, 5),          # forced edge
        (2, 3, 0, 10, 1),
    ]
    flows = solve_min_cost_flow(3, arcs)
    assert flows == [1, 1, 1]


def test_numpy_twins_match_device_kernels():
    """The host (numpy) ingest kernels must agree exactly with the jitted
    device kernels they mirror (packing.py)."""
    rng = np.random.default_rng(3)
    reads = _random_reads(rng, 80, 5, 70)
    codes, lens = _pad(reads)
    codes = np.asarray(codes)
    rc_dev = np.asarray(packing.reverse_complement_codes(codes, lens))
    rc_np = packing.reverse_complement_codes_np(codes, lens)
    np.testing.assert_array_equal(rc_dev, rc_np)
    can_dev, rev_dev = packing.canonicalize_codes(codes, lens)
    can_np, rev_np = packing.canonicalize_codes_np(codes, lens)
    np.testing.assert_array_equal(np.asarray(can_dev), can_np)
    np.testing.assert_array_equal(np.asarray(rev_dev), rev_np)
    for mo in (4, 20):
        np.testing.assert_array_equal(
            np.asarray(packing.qc_mask(codes, lens, mo)),
            packing.qc_mask_np(codes, lens, mo))


def _ragged_codes(rng, n, lmax):
    """Random codes with per-row lengths in [88, lmax], padded with code 4
    (PAD_CODE) past each row's end."""
    lens = rng.integers(88, lmax + 1, n)
    codes = rng.integers(0, 4, (n, lmax)).astype(np.uint8)
    codes[np.arange(lmax)[None, :] >= lens[:, None]] = packing.PAD_CODE
    return codes


@pytest.mark.parametrize("n,lmax,l,ragged", [
    (3, 50, 11, False), (300, 100, 39, False), (64, 130, 64, False),
    (257, 150, 39, True)])
def test_window_hashes_match_rolling_scan(n, lmax, l, ragged):
    """The production window hashes (jnp convolution) must be bit-identical
    to the rolling-scan reference, padded rows included."""
    from metagenomics_tpu.ops.device_overlap import (window_hashes_scan,
                                                     window_hashes_u32)
    rng = np.random.default_rng(5 + n)
    codes = (_ragged_codes(rng, n, lmax) if ragged
             else rng.integers(0, 5, (n, lmax)).astype(np.uint8))
    a = np.asarray(window_hashes_scan(codes, l))
    b = np.asarray(window_hashes_u32(codes, l))
    assert b.shape == (n, lmax - l + 1)
    np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_window_hashes_on_gpu(gpu):
    """Compiled for the card, the production and reference window-hash
    forms agree bit for bit (chip_smoke.py repeats this at 2M reads)."""
    import jax
    from metagenomics_tpu.ops.device_overlap import (window_hashes_scan,
                                                     window_hashes_u32)
    codes = jax.device_put(_ragged_codes(np.random.default_rng(9), 4096,
                                         150), gpu)
    a = window_hashes_scan(codes, 39)
    b = window_hashes_u32(codes, 39)
    assert {d.platform for d in b.devices()} == {"gpu"}
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_multichunk_stream_matches_single_chunk():
    """When the candidate total exceeds the chunk capacity, the streamed
    multi-chunk output must equal the single-chunk stream exactly (the
    tier-rounded emit window must not double-count the next chunk's rows)."""
    import os
    from metagenomics_tpu.dataset import Dataset
    from metagenomics_tpu.ops.device_overlap import DeviceOverlapPipeline

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ds = Dataset([], [os.path.join(repo, "golden", "data", "se_hard.fasta")],
                 40, log=lambda *a, **k: None)
    pipe = DeviceOverlapPipeline(ds, 40)
    c0, r0, m0 = pipe.stream(check_cont=True)

    old_cap = DeviceOverlapPipeline.MAX_CAP
    try:
        DeviceOverlapPipeline.MAX_CAP = 1 << 16   # force many chunks
        pipe2 = DeviceOverlapPipeline(ds, 40)
        c1, r1, m1 = pipe2.stream(check_cont=True)
    finally:
        DeviceOverlapPipeline.MAX_CAP = old_cap

    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(m0, m1)
