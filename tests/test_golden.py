"""Golden byte-equality tests against the reference assembler's artifacts.

The fixtures under golden/out/* were produced by the compiled reference
binary (see golden/make_testdata.py and the harness commit); every staged
artifact must match byte-for-byte.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden")

CONFIGS = {
    "se_small": ["-se", "1", os.path.join(GOLDEN, "data", "se_small.fasta")],
    "se_mixlen": ["-se", "1", os.path.join(GOLDEN, "data", "se_mixlen.fasta")],
    "pe_small": ["-pe", "1", os.path.join(GOLDEN, "data", "pe_small.fasta")],
    "pe_meta": ["-pe", "1", os.path.join(GOLDEN, "data", "pe_meta.fastq")],
    # realistic PE FASTQ (make_realdata.py): sequencing errors, Ns,
    # low-complexity junk, ragged lengths, lowercase — ~19% of reads
    # QC-rejected, repeat structure from IS elements + a 2%-divergent
    # segmental duplication (SURVEY M0 real-read debt, VERDICT r3 item 8)
    "pe_real": ["-pe", "1", os.path.join(GOLDEN, "data", "pe_real.fastq")],
    # combined PE + SE run: dataset numbering continues across file kinds,
    # mate store only touches the PE dataset, contained reads from the SE
    # mixed-length set remap PE mate pairs
    "mix_ps": ["-pe", "1", os.path.join(GOLDEN, "data", "pe_small.fasta"),
               "-se", "1", os.path.join(GOLDEN, "data", "se_mixlen.fasta")],
    # fuzz-derived SE dataset (planted 300 bp repeat, mixed 60-100 bp reads)
    # that provokes heap-reuse-dependent self-loop twin selection: the
    # reference emits whichever twin has the LOWER malloc address
    # (OverlapGraph.cpp:460), and here glibc tcache reuse inverts two pairs
    # created by late-phase merges.  Pins GraphCore's heap model
    # (core.py _alloc_addr/_free_addr) — the serial-order model got
    # graph2..contigs4 wrong on this input.
    "se_heap": ["-se", "1", os.path.join(GOLDEN, "data", "se_heap.fasta")],
}

ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]

def check_flow_output(name, got_path, want_path):
    """_flow.output byte-parity check.

    The line order of CS2's solution file (its parser's grouped-by-tail
    slot order permuted by the solver's price_in/price_out arc-suspension
    EXCHANGEs) and the flow split among identical-cost parallel arcs are
    both trajectory artifacts; the replay solver (cs2replay.py) reproduces
    the trajectory, so the files are byte-equal on every config.
    """
    got = open(got_path, "rb").read()
    want = open(want_path, "rb").read()
    assert got == want, "_flow.output mismatch: %s" % name


@pytest.mark.parametrize("engine", ["native", "python", "device", "hybrid"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_config(name, engine, tmp_path):
    """Full-CLI byte-equality per engine.  The `device` row runs the
    JAX overlap pipeline (ops/device_overlap.py, canonical stream +
    native replay) end-to-end on the CPU backend — the same program
    chip_smoke.py runs compiled for the GPU.  The `hybrid` row exercises
    the CPU+device shard split with global cross-shard containment (small
    goldens fall back to the device pipeline below the read-count floor
    — both paths of the engine dispatch get covered across configs)."""
    args = CONFIGS[name]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    if engine == "python":
        env["MGTPU_NO_NATIVE"] = "1"
    elif engine in ("device", "hybrid"):
        env["MGTPU_OVERLAP_ENGINE"] = engine
    proc = subprocess.run(
        [sys.executable, "-m", "metagenomics_tpu.cli", *args, "-f", "t_",
         "-l", "40"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for art in ARTIFACTS:
        got = (tmp_path / ("t_" + art)).read_bytes()
        want_path = os.path.join(GOLDEN, "out", name, "g_" + art)
        want = open(want_path, "rb").read()
        assert got == want, "artifact mismatch: %s %s" % (name, art)
    check_flow_output(name, str(tmp_path / "t__flow.output"),
                      os.path.join(GOLDEN, "out", name, "g__flow.output"))
    # the full CLI stdout must match the captured reference log modulo
    # timings/memory/paths (normalized-log parity)
    from logutil import assert_log_equal
    assert_log_equal(proc.stdout,
                     os.path.join(GOLDEN, "out", name, "log.txt"),
                     "%s/%s" % (name, engine))


def test_resume_from_unitig(tmp_path):
    """The -s resume path must reproduce the post-unitig artifacts."""
    args = CONFIGS["pe_small"]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    import shutil
    shutil.copy(os.path.join(GOLDEN, "out", "pe_small", "g_.unitig"),
                tmp_path / "t_.unitig")
    proc = subprocess.run(
        [sys.executable, "-m", "metagenomics_tpu.cli", *args, "-f", "t_",
         "-l", "40", "-s"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for art in ["contigs1.fasta", "contigs2.fasta", "contigs3.fasta",
                "contigs4.fasta"]:
        got = (tmp_path / ("t_" + art)).read_bytes()
        want = open(os.path.join(GOLDEN, "out", "pe_small", "g_" + art),
                    "rb").read()
        assert got == want, "resume artifact mismatch: %s" % art
    from logutil import assert_log_equal
    assert_log_equal(proc.stdout,
                     os.path.join(GOLDEN, "out", "pe_small",
                                  "log_resume.txt"), "pe_small/-s")


def test_resume_se_heap_self_consistent(tmp_path):
    """Resume on the heap-model config: our -s run reproduces OUR full-run
    artifacts byte-for-byte (the model is self-consistent), while the
    REFERENCE's own resume run emits different contigs2-4 than its full
    run on the same input (fresh-process heap history changes its pointer
    tie-breaks; captured as resume_contigs*.fasta).  Its resume LOG still
    normalizes equal.  See COMPONENTS.md known deviations."""
    import shutil
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    out = os.path.join(GOLDEN, "out", "se_heap")
    shutil.copy(os.path.join(out, "g_.unitig"), tmp_path / "t_.unitig")
    proc = subprocess.run(
        [sys.executable, "-m", "metagenomics_tpu.cli", *CONFIGS["se_heap"],
         "-f", "t_", "-l", "40", "-s"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for i in (1, 2, 3, 4):
        got = (tmp_path / ("t_contigs%d.fasta" % i)).read_bytes()
        want = open(os.path.join(out, "g_contigs%d.fasta" % i), "rb").read()
        assert got == want, "resume self-consistency: contigs%d" % i
    from logutil import assert_log_equal
    assert_log_equal(proc.stdout, os.path.join(out, "log_resume.txt"),
                     "se_heap/-s")
    # pin the documented reference behavior: its resume run's contigs2
    # really do differ from its full run's
    full2 = open(os.path.join(out, "g_contigs2.fasta"), "rb").read()
    res2 = open(os.path.join(out, "resume_contigs2.fasta"), "rb").read()
    assert full2 != res2
