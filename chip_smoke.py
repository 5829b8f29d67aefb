#!/usr/bin/env python
"""Smoke test of the assembler's device path on an NVIDIA GPU.

Runs from the root of a checkout, on a machine with one card:

    python chip_smoke.py [--seed N] [--pairs N]
    python chip_smoke.py --four-gpus [--seed N] [--pairs N]   (four cards)

Phases, in order; a failing phase ends the run with a non-zero exit code
and no result line:

  card       nvidia-smi's name and power limit; JAX must report a GPU.
  kernels    on the mock community's 2M reads (lmax 150, hash_len 39):
             the production window hashes bit-identical to the rolling-
             scan reference and to numpy, also on a ragged padded batch;
             the setup, probe-join and emit programs compiled at those
             widths with their memory_analysis(); stage times; and the
             setup program timed with three window-hash forms (lax.scan,
             the jnp convolution, a Pallas kernel through Triton).
  golden     the nine golden configurations through metagenomics_tpu.cli
             with engine auto: the device engine must be chosen, its
             arrays must live on the GPU, and all 12 artifacts must be
             byte-equal to golden/out/<cfg>/g_*.
  scale      a seeded 2x150 bp paired-end mock community (1M pairs by
             default) through the CLI with engine auto, then with the
             native CPU engine: all 12 artifacts byte-equal.
  four-gpus  with --four-gpus only (then card and this phase run, nothing
             else): the sharded engine over meshes (4,1), (2,2) and (1,4)
             on the scale data, every artifact byte-equal to a one-device
             device-engine run in the same process.

Everything runs in this one process, so one process holds the cards.  The
last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import metagenomics_tpu  # noqa: E402  (fails outside a checkout)

if os.path.dirname(os.path.dirname(os.path.abspath(
        metagenomics_tpu.__file__))) != REPO:
    raise SystemExit("chip_smoke.py must run from the root of a checkout")

GOLDEN = os.path.join(REPO, "golden")
ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input", "_flow.output",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]
MIN_OVERLAP = 40
HASH_LEN = MIN_OVERLAP - 1
REPS = 5
PAIRS = 1_000_000          # 2M reads: the canonical record still fits 32 bits


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


# ----------------------------------------------------------------- card

def phase_card(n_expected):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    cards = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    for c in cards:
        log(c)
    check(cards, "nvidia-smi lists no card")
    import jax
    from metagenomics_tpu.utils import enable_compile_cache
    log("compile cache:", enable_compile_cache())
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          "JAX found no GPU (platform %r)" % devs[0].platform)
    check(len(devs) >= n_expected,
          "need %d GPUs, JAX sees %d" % (n_expected, len(devs)))
    stats = devs[0].memory_stats() or {}
    log("jax device_kind=%s count=%d bytes_limit=%s"
        % (devs[0].device_kind, len(devs), stats.get("bytes_limit")))
    return cards[0], devs


# -------------------------------------------------------------- kernels

def window_hashes_triton(codes, hash_len, block_rows=64, interpret=False):
    """The window-hash convolution as a Pallas kernel through Triton: one
    program per block of rows, l shifted loads of the code block, Horner
    multiply-adds in registers.  Columns are padded to a power of two so
    every shifted load stays inside the block.  Timed against the jnp
    form in phase_kernels; the pipeline uses window_hashes_u32."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu
    from metagenomics_tpu.ops import device_overlap as dov

    n, lmax = codes.shape
    npos = lmax - hash_len + 1
    cols = pl.next_power_of_2(npos)
    width = pl.next_power_of_2(hash_len - 1 + cols)
    n_pad = -(-n // block_rows) * block_rows
    padded = jnp.pad(codes, ((0, n_pad - n), (0, width - lmax)))

    def kernel(c_ref, o_ref):
        w1 = jnp.zeros((block_rows, cols), jnp.uint32)
        w2 = jnp.zeros((block_rows, cols), jnp.uint32)
        for k in range(hash_len):
            t = (c_ref[:, pl.ds(k, cols)].astype(jnp.uint32) & 3) + 1
            w1 = w1 * dov._B1 + t
            w2 = w2 * dov._B2 + t
        o_ref[...] = w1 * dov._M1 ^ w2 * dov._M2

    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_pad, cols), jnp.uint32),
        grid=(n_pad // block_rows,),
        in_specs=[pl.BlockSpec((block_rows, width), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((block_rows, cols), lambda i: (i, 0)),
        compiler_params=plgpu.CompilerParams(num_warps=4),
        backend="triton", name="window_hashes_triton", interpret=interpret,
    )(padded)
    return out[:n, :npos]


def numpy_window_hashes(codes, hash_len):
    """Independent numpy rolling-hash reference (uint32 wrap-around)."""
    from metagenomics_tpu.ops import device_overlap as dov
    c = (codes.astype(np.uint32) & 3) + 1
    n, lmax = c.shape
    npos = lmax - hash_len + 1
    out = []
    for base in (dov._B1, dov._B2):
        h = np.zeros((n, lmax + 1), np.uint32)
        for p in range(lmax):
            h[:, p + 1] = h[:, p] * base + c[:, p]
        bl = np.uint32(pow(int(base), hash_len, 1 << 32))
        out.append(h[:, hash_len:hash_len + npos] - h[:, :npos] * bl)
    return out[0] * dov._M1 ^ out[1] * dov._M2


def timed(fn, reps=REPS):
    """Compile (first call, timed separately), then `reps` timed calls
    each ending in block_until_ready; returns (compile_s, [times])."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, ts


def fmt_times(ts):
    return "median %.6f s min %.6f s max %.6f s (n=%d)" % (
        statistics.median(ts), min(ts), max(ts), len(ts))


def mem_line(compiled):
    m = compiled.memory_analysis()
    return ("argument %d B, output %d B, temp %d B, alias %d B, code %d B"
            % (m.argument_size_in_bytes, m.output_size_in_bytes,
               m.temp_size_in_bytes, m.alias_size_in_bytes,
               m.generated_code_size_in_bytes))


def phase_kernels(card, fasta):
    import jax
    import jax.numpy as jnp
    from metagenomics_tpu.dataset import Dataset
    from metagenomics_tpu.ops import device_overlap as dov

    t0 = time.perf_counter()
    ds = Dataset([fasta], [], MIN_OVERLAP, log=lambda *a, **k: None)
    log("kernels: dataset %d unique reads, lmax %d, ingest %.3f s"
        % (ds.number_of_unique_reads, ds.codes_fwd.shape[1],
           time.perf_counter() - t0))
    codes = jnp.asarray(ds.codes_fwd)
    n1, lmax = codes.shape

    # ---- bit identity of the window hashes
    kept = dov.window_hashes_u32(codes, HASH_LEN)
    ref = dov.window_hashes_scan(codes, HASH_LEN)
    check(bool(jnp.array_equal(kept, ref)),
          "window_hashes_u32 differs from the scan reference at %dx%d"
          % (n1, lmax))
    sub = np.asarray(ds.codes_fwd[:65536])
    check(np.array_equal(np.asarray(kept[:65536]),
                         numpy_window_hashes(sub, HASH_LEN)),
          "window_hashes_u32 differs from the numpy reference")
    tri = jax.jit(window_hashes_triton, static_argnames=("hash_len",))
    check(bool(jnp.array_equal(tri(codes, hash_len=HASH_LEN), ref)),
          "Triton window hashes differ from the scan reference")
    del kept, ref
    rng = np.random.default_rng(7)
    lens = rng.integers(88, 151, 4096)
    rag = rng.integers(0, 4, (4096, 150)).astype(np.uint8)
    rag[np.arange(150)[None, :] >= lens[:, None]] = 4     # padding code
    want = numpy_window_hashes(rag, HASH_LEN)
    for name, fn in (("u32", dov.window_hashes_u32),
                     ("scan", dov.window_hashes_scan),
                     ("triton", tri)):
        got = np.asarray(fn(jnp.asarray(rag), hash_len=HASH_LEN))
        check(np.array_equal(got, want),
              "ragged batch: %s window hashes differ from numpy" % name)
    log("kernels: window hashes bit-identical at %dx%d (hash_len %d) and "
        "on a ragged padded batch (lengths 88-150)" % (n1, lmax, HASH_LEN))

    # ---- compile the pipeline programs at these widths
    pipe = dov.DeviceOverlapPipeline(ds, MIN_OVERLAP)
    pf = jnp.asarray(dov.pack_codes_host(ds.codes_fwd))
    lengths = pipe.lengths
    static = dict(hash_len=HASH_LEN, w=pipe.w, wp=pipe.wp, lmax=lmax)
    log("kernels: _setup_kernel memory:",
        mem_line(dov._setup_kernel.lower(pf, lengths, **static).compile()))
    m = int(pipe.sk.shape[0])
    sum_block = 1 << max(3, min(12, (1 << 31).bit_length()
                                - max(m, 1).bit_length() - 2))
    log("kernels: _probe_join memory:",
        mem_line(dov._probe_join.lower(pipe.hf, lengths, pipe.sk, HASH_LEN,
                                       sum_block).compile()))
    cap, nqt, chunks = pipe._plan_chunks()
    rk_pad, rleft_pad, rcnt_pad = pipe._padded(nqt)
    log("kernels: %d hit queries, %d candidates, cap %d, nqt %d, %d "
        "chunk(s) (MAX_CAP %d %s)"
        % (pipe.h_total, pipe.grand, cap, nqt, len(chunks), pipe.MAX_CAP,
           "binds" if pipe.grand > pipe.MAX_CAP else "does not bind"))

    def emit_args(h0, nh):
        """_emit2's arguments for one chunk of the canonical (dedup)
        uniform-length stream, as stream_canon passes them."""
        return (pipe.packed2, lengths, rk_pad, rleft_pad, rcnt_pad, pipe.sid,
                np.int32(h0), np.int32(nh), np.int32(0), HASH_LEN, nqt, cap,
                pipe.npos, pipe.w, pipe.qw_max, False, pipe.off_bits,
                pipe.uniform_len, True)
    log("kernels: _emit2 memory:",
        mem_line(dov._emit2.lower(*emit_args(0, 0)).compile()))

    # ---- stage times
    label = "(%s)" % card
    c, ts = timed(lambda: dov._probe_join(pipe.hf, lengths, pipe.sk,
                                          HASH_LEN, sum_block))
    log("stage probe_join: first call %.3f s, %s %s" % (c, fmt_times(ts),
                                                        label))
    c, ts = timed(lambda: [dov._emit2(*emit_args(h0, nh))
                           for h0, nh in chunks])
    log("stage emit (%d chunks): first call %.3f s, %s %s"
        % (len(chunks), c, fmt_times(ts), label))
    c, ts = timed(lambda: pipe.stream_canon(check_cont=False)[1])
    log("stage emit+fetch (stream_canon): first call %.3f s, %s %s"
        % (c, fmt_times(ts), label))

    # ---- the three window-hash forms, alone and inside the setup program
    forms = {
        "scan": dov.window_hashes_scan,
        "jnp_conv": dov.window_hashes_u32,
        "pallas_triton": tri,
    }
    setups = {
        name: jax.jit(functools.partial(dov.setup_program,
                                        window_hashes=fn),
                      static_argnames=dov._SETUP_STATIC)
        for name, fn in forms.items()}
    hash_t = {k: [] for k in forms}
    setup_t = {k: [] for k in forms}
    for name in forms:                       # compile everything first
        jax.block_until_ready(forms[name](codes, hash_len=HASH_LEN))
        jax.block_until_ready(setups[name](pf, lengths, **static))
    for _ in range(REPS):                    # interleaved rounds
        for name in forms:
            t0 = time.perf_counter()
            jax.block_until_ready(forms[name](codes, hash_len=HASH_LEN))
            hash_t[name].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            jax.block_until_ready(setups[name](pf, lengths, **static))
            setup_t[name].append(time.perf_counter() - t0)
    ref_out = setups["scan"](pf, lengths, **static)
    for name in forms:
        out = setups[name](pf, lengths, **static)
        for a, b in zip(out, ref_out):
            check(bool(jnp.array_equal(a, b)),
                  "setup program with %s hashes differs" % name)
        log("window hash [%s] at %dx%d: %s %s"
            % (name, n1, lmax, fmt_times(hash_t[name]), label))
        log("setup_kernel [%s] at %dx%d: %s %s"
            % (name, n1, lmax, fmt_times(setup_t[name]), label))


# --------------------------------------------------------------- golden

@contextlib.contextmanager
def engine_spy():
    """Record the engine each Assembler picks and the devices of every
    DeviceOverlapPipeline's arrays."""
    from metagenomics_tpu.assembler import Assembler
    from metagenomics_tpu.ops.device_overlap import DeviceOverlapPipeline
    seen = {"engines": [], "devices": []}
    build, init = Assembler._build_engine, DeviceOverlapPipeline.__init__

    def spy_build(self, graph):
        build(self, graph)
        seen["engines"].append(self.engine)

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        seen["devices"].append(
            {d.platform for x in (self.packed2, self.hf, self.sk, self.sid)
             for d in x.devices()})

    Assembler._build_engine = spy_build
    DeviceOverlapPipeline.__init__ = spy_init
    try:
        yield seen
    finally:
        Assembler._build_engine = build
        DeviceOverlapPipeline.__init__ = init


def run_cli(args, prefix, logfile):
    """metagenomics_tpu.cli.main on `args`; its stdout goes to logfile.
    Returns the wall seconds and the log text."""
    from metagenomics_tpu import cli
    t0 = time.perf_counter()
    with open(logfile, "w") as f, contextlib.redirect_stdout(f):
        cli.main(["metagenomics_tpu", *args, "-f", prefix,
                  "-l", str(MIN_OVERLAP)])
    wall = time.perf_counter() - t0
    with open(logfile) as f:
        return wall, f.read()


def compare_artifacts(prefix_a, prefix_b, what):
    for a in ARTIFACTS:
        with open(prefix_a + a, "rb") as fa, open(prefix_b + a, "rb") as fb:
            check(fa.read() == fb.read(), "%s: %s differs" % (what, a))


def golden_configs():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_golden import CONFIGS as easy
    from test_golden_hard import CONFIGS as hard
    return {**easy, **hard}


def phase_golden(td):
    configs = golden_configs()
    check(len(configs) == 9, "expected 9 golden configs, found %d"
          % len(configs))
    for name in sorted(configs):
        with engine_spy() as seen:
            wall, _ = run_cli(configs[name], os.path.join(td, name + "_"),
                              os.path.join(td, name + ".log"))
        check(seen["engines"] == ["device"],
              "%s: engine %s, expected device" % (name, seen["engines"]))
        check(seen["devices"] and all(d == {"gpu"} for d in seen["devices"]),
              "%s: pipeline arrays on %s" % (name, seen["devices"]))
        compare_artifacts(os.path.join(td, name + "_"),
                          os.path.join(GOLDEN, "out", name, "g_"), name)
        log("golden %s: device engine on gpu, 12 artifacts byte-equal, "
            "CLI %.3f s" % (name, wall))


# ---------------------------------------------------------------- scale

def phase_seconds(text):
    """Summed CLOCKSTOP seconds per function name of a CLI log."""
    out = {}
    for n, t in re.findall(
            r"Function (\w+)\(\) finished in ([\d.e+-]+) Seconds", text):
        out[n] = out.get(n, 0.0) + float(t)
    return out


def construction_seconds(text):
    ph = phase_seconds(text)
    return (ph.get("insertDataset", 0.0)
            + ph.get("buildOverlapGraphFromHashTable", 0.0))


def top_phases(text, k=8):
    ph = phase_seconds(text)
    ph.pop("main", None)
    return ", ".join("%s %.3f s" % (n, t) for n, t in
                     sorted(ph.items(), key=lambda x: -x[1])[:k])


def phase_scale(card, fasta, td):
    import jax
    with engine_spy() as seen:
        wall_d, text_d = run_cli(["-pe", "1", fasta],
                                 os.path.join(td, "dev_"),
                                 os.path.join(td, "dev.log"))
    check(seen["engines"] == ["device"],
          "scale: engine %s, expected device" % seen["engines"])
    check(all(d == {"gpu"} for d in seen["devices"]),
          "scale: pipeline arrays on %s" % seen["devices"])
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    os.environ["MGTPU_OVERLAP_ENGINE"] = "native"
    try:
        wall_n, text_n = run_cli(["-pe", "1", fasta],
                                 os.path.join(td, "nat_"),
                                 os.path.join(td, "nat.log"))
    finally:
        del os.environ["MGTPU_OVERLAP_ENGINE"]
    compare_artifacts(os.path.join(td, "dev_"), os.path.join(td, "nat_"),
                      "scale device vs native")
    uniq = re.search(r"Number of unique reads: (\d+)", text_d)
    log("scale: %s unique reads; construction device %.3f s, native "
        "%.3f s; CLI wall device %.3f s, native %.3f s; "
        "peak_bytes_in_use %s (%s)"
        % (uniq.group(1) if uniq else "?", construction_seconds(text_d),
           construction_seconds(text_n), wall_d, wall_n, peak, card))
    log("scale: device CLI phases: %s" % top_phases(text_d))
    log("scale: native CLI phases: %s" % top_phases(text_n))
    log("scale: 12 artifacts byte-equal, device engine vs native engine")


# ------------------------------------------------------------ four gpus

def phase_four_gpus(card, fasta, td):
    import jax
    from metagenomics_tpu.assembler import Assembler
    from metagenomics_tpu.config import AssemblerConfig
    from metagenomics_tpu.parallel import make_mesh

    def run(engine, mesh, prefix):
        cfg = AssemblerConfig(paired_end_files=[fasta],
                              min_overlap=MIN_OVERLAP,
                              output_prefix=os.path.join(td, prefix),
                              overlap_engine=engine, mesh=mesh)
        asm = Assembler(cfg, log=lambda *a, **k: None)
        t0 = time.perf_counter()
        asm.run()
        wall = time.perf_counter() - t0
        check(asm.engine == engine, "ran %s, expected %s"
              % (asm.engine, engine))
        return wall, asm.timings.get("buildOverlapGraphFromHashTable")

    check("MGTPU_OVERLAP_ENGINE" not in os.environ,
          "unset MGTPU_OVERLAP_ENGINE for --four-gpus")
    wall, build = run("device", None, "one_")
    log("four-gpus: one-device run %.3f s (construction %.3f s) (%s)"
        % (wall, build, card))
    devs = jax.devices()[:4]
    for dp, ix in ((4, 1), (2, 2), (1, 4)):
        prefix = "s%d_%d_" % (dp, ix)
        wall, build = run("sharded", make_mesh(dp=dp, ix=ix, devices=devs),
                          prefix)
        compare_artifacts(os.path.join(td, prefix),
                          os.path.join(td, "one_"),
                          "sharded (%d,%d)" % (dp, ix))
        log("four-gpus: sharded (dp=%d, ix=%d) %.3f s (construction "
            "%.3f s), 12 artifacts byte-equal to the one-device run (%s)"
            % (dp, ix, wall, build, card))


# ----------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the mock community (default 0)")
    ap.add_argument("--pairs", type=int, default=PAIRS,
                    help="read pairs in the mock community (default 1M)")
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded comparison on four cards")
    args = ap.parse_args(argv)

    card, devs = phase_card(4 if args.four_gpus else 1)
    from metagenomics_tpu.tools.mock_community import (mock_community,
                                                       write_fasta)
    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "mock_pe.fasta")
        t0 = time.perf_counter()
        write_fasta(mock_community(args.pairs, args.seed), fasta)
        log("mock community: %d pairs of 2x150 bp, seed %d, %.3f s"
            % (args.pairs, args.seed, time.perf_counter() - t0))
        if args.pairs != PAIRS:
            log("mock community cut from %d to %d pairs" % (PAIRS,
                                                            args.pairs))
        if args.four_gpus:
            phase_four_gpus(card, fasta, td)
        else:
            phase_kernels(card, fasta)
            phase_golden(td)
            phase_scale(card, fasta, td)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        sys.stderr.write("chip_smoke: FAILED: %s\n" % exc)
        raise SystemExit(1)
