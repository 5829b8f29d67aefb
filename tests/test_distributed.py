"""Two-process jax.distributed smoke test for parallel/launcher.py.

Spawns two localhost CPU processes that join one JAX runtime through
initialize_distributed (MGTPU_* env wiring), form a global mesh spanning
both, and run a cross-process collective.  This exercises the non-no-op
launcher branch end-to-end — the wiring the multi-host deployment uses.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
import numpy as np
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from metagenomics_tpu.parallel.launcher import initialize_distributed

# config.update must precede any backend query — it does NOT initialize
# the backend, so the distributed-init ordering constraint is still met
jax.config.update("jax_platforms", "cpu")
ok = initialize_distributed(log=lambda *a, **k: None)
assert ok, "initialize_distributed returned False"
assert jax.process_count() == 2, jax.process_count()
pid = jax.process_index()

from jax.experimental import multihost_utils
got = multihost_utils.process_allgather(np.asarray([pid * 10 + 7]))
assert sorted(got.ravel().tolist()) == [7, 17], got
print("DIST_OK", pid)
"""


def test_two_process_distributed(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["MGTPU_COORDINATOR"] = "127.0.0.1:%d" % port
        env["MGTPU_NUM_PROCESSES"] = "2"
        env["MGTPU_PROCESS_ID"] = str(rank)
        env.pop("XLA_FLAGS", None)   # 1 CPU device per process
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d:\n%s" % (rank, out[-3000:])
        assert "DIST_OK %d" % rank in out


def test_two_process_full_pipeline(tmp_path):
    """The FULL assembler CLI across 2 processes on one global mesh: both
    ranks join one jax.distributed runtime, run the sharded engine over a
    dp=2 mesh spanning the processes, and every staged artifact from each
    rank must byte-match the golden reference outputs.  The input is the
    adversarial PAIRED-END set, so insert-size estimation, mate-pair path
    merging, the scaffolder and resolveNodes all execute under the
    multi-process mesh (VERDICT r3 item 7)."""
    golden = os.path.join(REPO, "golden")
    artifacts = [
        "_sortedReads.fasta", ".unitig", "_flow.input",
        "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
        "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
    ]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["MGTPU_COORDINATOR"] = "127.0.0.1:%d" % port
        env["MGTPU_NUM_PROCESSES"] = "2"
        env["MGTPU_PROCESS_ID"] = str(rank)
        env["MGTPU_OVERLAP_ENGINE"] = "sharded"
        env.pop("XLA_FLAGS", None)   # 1 CPU device per process -> dp=2
        rankdir = tmp_path / ("rank%d" % rank)
        rankdir.mkdir()
        procs.append((rankdir, subprocess.Popen(
            [sys.executable, "-m", "metagenomics_tpu.cli",
             "-pe", "2", os.path.join(golden, "data", "pe_hard_a.fasta"),
             os.path.join(golden, "data", "pe_hard_b.fasta"),
             "-f", "t_", "-l", "40"],
            env=env, cwd=rankdir,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outs = []
    for _, p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, ((rankdir, p), out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d:\n%s" % (rank, out[-3000:])
        for art in artifacts:
            got = (rankdir / ("t_" + art)).read_bytes()
            want = open(os.path.join(golden, "out", "pe_hard",
                                     "g_" + art), "rb").read()
            assert got == want, \
                "rank %d artifact mismatch: %s" % (rank, art)
        # the PE late phases must actually have fired under the mesh
        assert "Pairs of Edges merged out of" in out
        assert "Average distance:" in out      # scaffolder merge lines
        assert "Merging edges (" in out        # resolveNodes
