#!/usr/bin/env python
"""Per-engine construction-phase measurement at 1M reads on the default
backend (the GPU where there is one).

At 1M reads the device engine's fixed costs (dispatch, per-run sync round
trips) amortize.  This tool measures the construction span
(DeviceOverlapPipeline/hybrid/native build, identical to the reference's
insertDataset + buildOverlapGraphFromHashTable span) for each engine,
byte-compares every engine's `.unitig` against the reference binary's, and
records the reference's own CLOCKSTOP rate at this scale.  Results land in
SCALE_1M_ENGINES.json.

Usage: python tools/measure_engines_1m.py [--skip-reference]
"""

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DATA = os.path.join(REPO, "bench_data", "scale_se.fasta")
REF = os.path.join(REPO, "golden", "metagenomics_ref_O0")
OUT = os.path.join(REPO, "SCALE_1M_ENGINES.json")


def main():
    import jax
    from metagenomics_tpu.utils import enable_compile_cache
    enable_compile_cache()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from measure_scale import gen_data
    from metagenomics_tpu.config import AssemblerConfig
    from metagenomics_tpu.dataset import Dataset
    from metagenomics_tpu.graph import OverlapGraph

    gen_data(1_000_000)                      # 1M-read single-end set
    ds = Dataset([], [DATA], 40, log=lambda *a, **k: None)
    n = ds.number_of_unique_reads
    cfg = AssemblerConfig(min_overlap=40, single_end_files=[DATA])

    def build(engine):
        g = OverlapGraph(ds, cfg, log=lambda *a, **k: None)
        ds.super_read_id[:] = 0
        t0 = time.time()
        if engine == "native":
            assert g.build_full_native()
        elif engine == "hybrid":
            assert g.build_hybrid()
        else:
            from metagenomics_tpu.ops.device_overlap import (
                DeviceOverlapPipeline)
            g.build_from_pipeline(DeviceOverlapPipeline(ds, 40))
        dt = time.time() - t0
        g.save_graph_to_file("/tmp/m1m_%s.unitig" % engine)
        return dt

    result = {"n_unique_reads": n, "backend": jax.default_backend(),
              "engines": {}}
    for engine in ("native", "device", "hybrid"):
        build(engine)                        # warm-up / compile
        best = min(build(engine) for _ in range(3))
        result["engines"][engine] = {
            "construction_s": round(best, 2),
            "reads_per_s": round(n / best, 1)}

    ref_a = "/tmp/m1m_native.unitig"
    equal = all(open("/tmp/m1m_%s.unitig" % e, "rb").read()
                == open(ref_a, "rb").read() for e in ("device", "hybrid"))
    result["unitig_equal_across_engines"] = equal

    if "--skip-reference" not in sys.argv and os.path.exists(REF):
        d = "/tmp/m1m_ref"
        os.makedirs(d, exist_ok=True)
        t0 = time.time()
        proc = subprocess.run([REF, "-se", "1", DATA, "-f", "r_", "-l",
                               "40"], cwd=d, capture_output=True,
                              text=True, timeout=3600)
        wall = time.time() - t0
        fin = dict(re.findall(
            r"Function (\w+)\(\) finished in ([\d.e+-]+) Seconds",
            proc.stdout))
        span = float(fin.get("insertDataset", 0)) + float(
            fin.get("buildOverlapGraphFromHashTable", 0))
        result["reference_O0"] = {
            "construction_s": round(span, 2),
            "reads_per_s": round(n / span, 1) if span else None,
            "e2e_s": round(wall, 1)}
        result["unitig_equal_reference"] = (
            open(os.path.join(d, "r_.unitig"), "rb").read()
            == open(ref_a, "rb").read())
        for e, rec in result["engines"].items():
            rec["vs_reference_at_1m"] = round(
                rec["reads_per_s"] / result["reference_O0"]["reads_per_s"],
                2)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
