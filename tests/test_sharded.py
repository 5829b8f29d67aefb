"""Sharded (multi-device) overlap pipeline: byte-equality with the
single-device run.

These run on the 8-virtual-CPU-device mesh the conftest provisions.  The
unit layer asserts the ShardedOverlapPipeline's survivor stream is
IDENTICAL to DeviceOverlapPipeline's for every (dp, ix) mesh shape; the
integration layer runs the full CLI with MGTPU_OVERLAP_ENGINE=sharded and
byte-diffs every staged artifact against the golden reference outputs —
the same oracle the single-device engines pass.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden")

ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]


@pytest.mark.parametrize("dp,ix", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("name,mixed", [("se_small", False),
                                        ("se_mixlen", True)])
def test_stream_matches_single_device(name, mixed, dp, ix):
    from metagenomics_tpu.dataset import Dataset
    from metagenomics_tpu.ops.device_overlap import DeviceOverlapPipeline
    from metagenomics_tpu.parallel.sharded import ShardedOverlapPipeline
    from metagenomics_tpu.parallel.mesh import make_mesh

    ds = Dataset([], [os.path.join(GOLDEN, "data", name + ".fasta")], 40,
                 log=lambda *a, **k: None)
    c0, r0, m0 = DeviceOverlapPipeline(ds, 40).stream(check_cont=mixed)
    sp = ShardedOverlapPipeline(ds, 40, mesh=make_mesh(dp=dp, ix=ix))
    c1, r1, m1 = sp.stream(check_cont=mixed)
    assert np.array_equal(c0, c1)
    assert np.array_equal(r0, r1)
    assert np.array_equal(m0, m1)


@pytest.mark.parametrize("name,args", [
    ("pe_small", ["-pe", "1", os.path.join(GOLDEN, "data",
                                           "pe_small.fasta")]),
    ("se_hard", ["-se", "1", os.path.join(GOLDEN, "data",
                                          "se_hard.fasta")]),
    # PE adversarial set: mate-pair merge, scaffolder and resolveNodes all
    # fire under the sharded engine (VERDICT r3 item 7)
    ("pe_hard", ["-pe", "2", os.path.join(GOLDEN, "data", "pe_hard_a.fasta"),
                 os.path.join(GOLDEN, "data", "pe_hard_b.fasta")]),
    # realistic error-model FASTQ through the sharded engine
    ("pe_real", ["-pe", "1", os.path.join(GOLDEN, "data", "pe_real.fastq")]),
])
def test_sharded_cli_byte_equality(name, args, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["MGTPU_OVERLAP_ENGINE"] = "sharded"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    proc = subprocess.run(
        [sys.executable, "-m", "metagenomics_tpu.cli", *args, "-f", "t_",
         "-l", "40"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for art in ARTIFACTS:
        got = (tmp_path / ("t_" + art)).read_bytes()
        want = open(os.path.join(GOLDEN, "out", name, "g_" + art),
                    "rb").read()
        assert got == want, "sharded artifact mismatch: %s %s" % (name, art)
    from test_golden import check_flow_output
    check_flow_output(name, str(tmp_path / "t__flow.output"),
                      os.path.join(GOLDEN, "out", name, "g__flow.output"))


@pytest.mark.parametrize("dp,ix", [(4, 2)])
def test_sharded_multichunk_matches_single_chunk(dp, ix):
    """Forcing many row chunks (tiny per-device buffer) must not change the
    stream: chunk windows, bounded all_gathers and the ring verify are
    exercised across chunk boundaries."""
    from metagenomics_tpu.dataset import Dataset
    from metagenomics_tpu.parallel.sharded import ShardedOverlapPipeline
    from metagenomics_tpu.parallel.mesh import make_mesh

    ds = Dataset([], [os.path.join(GOLDEN, "data", "se_hard.fasta")], 40,
                 log=lambda *a, **k: None)
    mesh = make_mesh(dp=dp, ix=ix)
    sp = ShardedOverlapPipeline(ds, 40, mesh=mesh)
    c0, r0, m0 = sp.stream(check_cont=True)

    old = ShardedOverlapPipeline.MAX_CAP
    try:
        ShardedOverlapPipeline.MAX_CAP = 1 << 13
        sp2 = ShardedOverlapPipeline(ds, 40, mesh=mesh)
        c1, r1, m1 = sp2.stream(check_cont=True)
    finally:
        ShardedOverlapPipeline.MAX_CAP = old
    assert np.array_equal(c0, c1)
    assert np.array_equal(r0, r1)
    assert np.array_equal(m0, m1)


def test_collective_ledger_accounts_stream():
    """The collective ledger (parallel/collectives.py) must record every
    phase's collectives with nonzero wire volume on a multi-device mesh and
    produce a coherent report."""
    from metagenomics_tpu.dataset import Dataset
    from metagenomics_tpu.parallel.collectives import LEDGER
    from metagenomics_tpu.parallel.mesh import make_mesh
    from metagenomics_tpu.parallel.sharded import ShardedOverlapPipeline

    ds = Dataset([], [os.path.join(GOLDEN, "data", "se_small.fasta")], 40,
                 log=lambda *a, **k: None)
    LEDGER.reset()
    sp = ShardedOverlapPipeline(ds, 40, mesh=make_mesh(dp=4, ix=2))
    sp.stream(check_cont=False)
    rep = LEDGER.report()
    assert {"probe", "emit"} <= set(rep["phases"])
    assert rep["total_payload_bytes"] > 0
    assert rep["total_wire_bytes"] > 0
    ops = {c["op"] for p in rep["phases"].values()
           for c in p["collectives"]}
    assert {"all_gather", "all_to_all", "ppermute", "psum"} <= ops
    # wire model sanity: all_to_all moves (A-1)/A of its payload
    for p in rep["phases"].values():
        for c in p["collectives"]:
            if c["op"] == "all_to_all":
                a = c["axis_size"]
                assert c["wire_bytes"] == int(
                    c["payload_bytes"] * (a - 1) / a)


@pytest.mark.parametrize("seed,mo", [(100, 40), (103, 30)])
def test_sharded_fuzz_random_mixed(seed, mo, tmp_path):
    """Random mixed-length datasets through the sharded engine at stressed
    mesh shapes must match the single-device stream exactly (regression
    for the dynamic_slice start-clamp block loss found on pe_real)."""
    import jax

    from metagenomics_tpu.dataset import Dataset
    from metagenomics_tpu.ops.device_overlap import DeviceOverlapPipeline
    from metagenomics_tpu.parallel.mesh import make_mesh
    from metagenomics_tpu.parallel.sharded import ShardedOverlapPipeline

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, np.uint8)
    for k, v in zip(b"ACGT", b"TGCA"):
        comp[k] = v
    glen = int(rng.integers(20_000, 60_000))
    g = bases[rng.integers(0, 4, glen)]
    n = int(rng.integers(3_000, 9_000))
    lens = rng.integers(60, 140, n)
    starts = rng.integers(0, glen - 140, n)
    path = tmp_path / "f.fasta"
    with open(path, "wb") as f:
        for t in range(n):
            r = g[starts[t]:starts[t] + int(lens[t])]
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            f.write(b">r%d\n" % t)
            f.write(r.tobytes())
            f.write(b"\n")
    ds = Dataset([], [str(path)], mo, log=lambda *a, **k: None)
    base = DeviceOverlapPipeline(ds, mo).stream(check_cont=True)
    devs = jax.devices()
    for dp, ix in ((4, 2), (2, 4)):
        sp = ShardedOverlapPipeline(
            ds, mo, mesh=make_mesh(dp=dp, ix=ix, devices=devs[:dp * ix]))
        out = sp.stream(check_cont=True)
        for a, b in zip(base, out):
            np.testing.assert_array_equal(a, b)
