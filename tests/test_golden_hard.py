"""Golden byte-equality on ADVERSARIAL datasets that force the late pipeline
stages to run (they all fire 0 times on the easy golden sets — see
golden/make_harddata.py for the genome constructions):

  se_hard: four distinct 2-copy repeats (575-arc min-cost-flow instance),
           a repeat cycle (reduceLoops), a strain bubble (removeSimilarEdges)
  pe_hard: an X-node repeat resolved by mate pairs
           (findSupportByMatepairsAndMerge), a coverage-separable repeat
           (resolveNodes), and a sequencing gap bridged by mate pairs
           (scaffolder N-gap join in contigs3)

The captured reference logs (golden/out/*/log.txt) are asserted to show
NONZERO counters for each pass, so regressions in the data generator cannot
silently turn these back into easy tests.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden")

CONFIGS = {
    "se_hard": ["-se", "1", os.path.join(GOLDEN, "data", "se_hard.fasta")],
    "pe_hard": ["-pe", "2", os.path.join(GOLDEN, "data", "pe_hard_a.fasta"),
                os.path.join(GOLDEN, "data", "pe_hard_b.fasta")],
}

ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]


def _counter(log, pattern):
    """Sum all integers captured by `pattern` across the log."""
    return sum(int(m) for m in re.findall(pattern, log))


def test_reference_logs_prove_hard_passes_fire():
    """The captured reference logs must show every late pass firing."""
    se = open(os.path.join(GOLDEN, "out", "se_hard", "log.txt")).read()
    pe = open(os.path.join(GOLDEN, "out", "pe_hard", "log.txt")).read()
    # se_hard: similar edges, loops, flow instance size
    assert _counter(se, r"(\d+) edges to remove") > 0, "removeSimilarEdges"
    assert _counter(se, r"Loops removed: (\d+)") > 0, "reduceLoops"
    n_arcs = int(re.search(r"p min\s+\d+\s+(\d+)",
                 open(os.path.join(GOLDEN, "out", "se_hard",
                                   "g__flow.input")).read()).group(1))
    assert n_arcs >= 500, "flow instance must be nontrivial"
    # pe_hard: mate-pair merge, trees, scaffolder, resolveNodes, N gap
    assert _counter(pe, r"(\d+) Pairs of Edges merged out") > 0, \
        "findSupportByMatepairsAndMerge"
    assert _counter(pe, r"(\d+) trees removed") > 0, "reduceTrees"
    assert _counter(pe, r"supported\s+(\d+) times\. Average distance") > 0, \
        "scaffolder"
    assert _counter(pe, r"(\d+) edges merged") > 0, "resolveNodes"
    contigs3 = open(os.path.join(GOLDEN, "out", "pe_hard",
                                 "g_contigs3.fasta")).read()
    assert "N" in contigs3.split("\n", 1)[1], "scaffold N gap in contigs3"


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_hard_config(name, engine, tmp_path):
    args = CONFIGS[name]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    if engine == "python":
        env["MGTPU_NO_NATIVE"] = "1"
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
    from test_golden import check_flow_output
    check_flow_output(name, str(tmp_path / "t__flow.output"),
                      os.path.join(GOLDEN, "out", name, "g__flow.output"))
    from logutil import assert_log_equal
    assert_log_equal(proc.stdout,
                     os.path.join(GOLDEN, "out", name, "log.txt"),
                     "%s/%s" % (name, engine))
