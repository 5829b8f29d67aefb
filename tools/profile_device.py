"""Fine-grained profile of the device overlap pipeline on the bench set.

Measures, with explicit block_until_ready sync points:
  * host<->device copies: H2D / D2H bandwidth at several sizes, dispatch
    latency
  * per-stage device times: upload, setup kernel, probe join, emit, fetch
  * stream composition: survivor total, canonical-duplicate structure
  * native replay time from the fetched stream

Run:  python tools/profile_device.py     (on the GPU; generate the bench set
      first with `python bench.py`)
"""
import os
import sys
import time
import json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax
import jax.numpy as jnp

from metagenomics_tpu.utils import enable_compile_cache  # noqa: E402

MIN_OVERLAP = 40
DATA_FILE = os.path.join(REPO, "bench_data", "bench_se.fasta")


def bw_probe():
    out = {}
    # dispatch latency: tiny add round trip
    x = jnp.ones((8,), jnp.float32)
    x.block_until_ready()
    f = jax.jit(lambda a: a + 1)
    f(x).block_until_ready()
    ts = []
    for _ in range(10):
        t0 = time.time()
        f(x).block_until_ready()
        ts.append(time.time() - t0)
    out["dispatch_ms"] = round(1e3 * min(ts), 3)

    for mb in (1, 8, 32):
        a = np.ones((mb << 20) // 4, np.float32)
        ts = []
        for _ in range(3):
            t0 = time.time()
            d = jnp.asarray(a)
            d.block_until_ready()
            ts.append(time.time() - t0)
        out["h2d_%dMB_MBps" % mb] = round(mb / min(ts), 1)
        ts = []
        for _ in range(3):
            t0 = time.time()
            _ = np.asarray(d)
            ts.append(time.time() - t0)
        out["d2h_%dMB_MBps" % mb] = round(mb / min(ts), 1)
    return out


def main():
    enable_compile_cache()
    print("backend:", jax.default_backend(), jax.devices())
    print(json.dumps(bw_probe(), indent=1))

    from metagenomics_tpu.config import AssemblerConfig
    from metagenomics_tpu.dataset import Dataset
    from metagenomics_tpu.ops import device_overlap as dov
    from metagenomics_tpu import native

    ds = Dataset([], [DATA_FILE], MIN_OVERLAP, log=lambda *a, **k: None)
    cfg = AssemblerConfig(min_overlap=MIN_OVERLAP)
    n = ds.number_of_unique_reads
    print("unique reads:", n, "lmax:", ds.codes_fwd.shape[1])

    def staged_run(label):
        t = {}
        t0 = time.time()
        p = dov.DeviceOverlapPipeline.__new__(dov.DeviceOverlapPipeline)
        # --- replicate __init__ with sync points ---
        p.ds = ds
        p.hash_len = MIN_OVERLAP - 1
        lmax = ds.codes_fwd.shape[1]
        p.lmax = lmax
        p.w = (lmax + 15) // 16
        p.qw_max = (lmax - p.hash_len) >> 4
        p.wp = p.qw_max + p.w + 1
        n1 = ds.codes_fwd.shape[0]
        p.npos = lmax - p.hash_len + 1
        p.lengths = jnp.asarray(ds.lengths.astype(np.int32))
        t_pack0 = time.time()
        pf_host = dov.pack_codes_host(ds.codes_fwd)
        t["host_pack"] = time.time() - t_pack0
        t_up0 = time.time()
        pf = jnp.asarray(pf_host)
        pf.block_until_ready()
        t["upload"] = time.time() - t_up0
        t["upload_MB"] = pf_host.nbytes / 1e6
        t_set0 = time.time()
        p.packed2, p.hf, p.sk, p.sid = dov._setup_kernel(
            pf, p.lengths, p.hash_len, p.w, p.wp, lmax)
        p.sid.block_until_ready()
        t["setup_kernel"] = time.time() - t_set0
        m = int(p.sk.shape[0])
        sum_block = 1 << max(3, min(12, (1 << 31).bit_length()
                                    - max(m, 1).bit_length() - 2))
        t_pj0 = time.time()
        p.rk, p.rleft, p.rcnt, h_total, parts = dov._probe_join(
            p.hf, p.lengths, p.sk, p.hash_len, sum_block)
        p.rcnt.block_until_ready()
        t["probe_join"] = time.time() - t_pj0
        t_sc0 = time.time()
        p.h_total = int(h_total)
        p.grand = int(np.asarray(parts).sum(dtype=np.int64))
        t["scalars"] = time.time() - t_sc0
        nn = n1 - 1
        bits_r2 = max(1, nn.bit_length())
        bits_off = max(1, (lmax - MIN_OVERLAP + 1).bit_length())
        p.off_bits = bits_off if bits_r2 + 4 + bits_off <= 32 else -1
        lens = ds.lengths[1:]
        p.uniform_len = (int(lens[0])
                         if len(lens) and (lens == lens[0]).all() else -1)
        t["init_total"] = time.time() - t0
        # --- stream with sync between emit and fetch ---
        t_s0 = time.time()
        res = p.stream(check_cont=False)
        t["stream_total"] = time.time() - t_s0
        counts, r2, meta = res
        t_b0 = time.time()
        out = native.build_graph_stream(ds.lengths, counts, r2, meta,
                                        False, cfg.dead_end_length)
        t["build"] = time.time() - t_b0
        t["n_survivors"] = len(r2)
        t["h_total"] = p.h_total
        t["grand"] = p.grand
        print(label, json.dumps({k: (round(v, 4) if isinstance(v, float)
                                     else v) for k, v in t.items()}))
        return p, counts, r2, meta, out

    staged_run("warmup")
    for i in range(3):
        p, counts, r2, meta, out = staged_run("run%d" % i)

    # emit-only (no download) timing
    for i in range(3):
        t0 = time.time()
        p2 = dov.DeviceOverlapPipeline(ds, MIN_OVERLAP)
        p2.stream(check_cont=False, download=False)
        print("device_only run%d: %.4f" % (i, time.time() - t0))

    # stream composition: how much is canonically duplicated?
    r1 = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    eo = (meta & 3).astype(np.int64)
    eoff = (meta >> 4).astype(np.int64)
    lo = np.minimum(r1, r2)
    hi = np.maximum(r1, r2)
    print("survivors:", len(r1), "self-pairs r1==r2:", int((r1 == r2).sum()))
    # count how many appear exactly twice as unordered pairs (ignoring
    # orient/offset multiplicity)
    key = lo.astype(np.uint64) * np.uint64(n + 2) + hi.astype(np.uint64)
    uniq, cnt = np.unique(key, return_counts=True)
    import collections
    print("pair multiplicity histogram:",
          dict(collections.Counter(cnt.tolist()).most_common(8)))
    print("unique unordered pairs:", len(uniq),
          "vs survivors/2:", len(r1) / 2)


if __name__ == "__main__":
    main()
