"""End-to-end assembly driver (reference: MetaGenomics/main.cpp:23-109).

Phase order and artifact set match the reference exactly:
  build (or resume via -s from the .unitig checkpoint) -> flow ->
  contigs1 -> mate-pair merge loop -> contigs2 -> scaffold loop ->
  contigs3 -> resolve loop -> contigs4,
with the same loopLimit=15 caps on each of the three driver loops.
"""

import time

from .config import AssemblerConfig
from .dataset import Dataset
from .graph import OverlapGraph
from .index import OverlapIndex
from .utils import PhaseTimer

ENGINE_ENV = "MGTPU_OVERLAP_ENGINE"
ENGINES = ("native", "device", "hybrid", "sharded", "host")


def select_engine(backend, n_devices, env, configured="auto"):
    """Name of the overlap engine for the construction phase.

    Engines:
      native  — full C++ engine (index/scan/verify/BFS) on the host CPU
      device  — device-resident JAX pipeline on one device
                (ops/device_overlap.py): canonical-dedup stream plus
                on-device containment, replayed by the native library
      hybrid  — device shard + concurrent CPU shard with exact canonical
                merge (graph/build.py build_hybrid)
      sharded — SPMD pipeline over the ("dp", "ix") device mesh
                (parallel/sharded.py)
      host    — numpy join + device verify (test reference)

    The environment variable MGTPU_OVERLAP_ENGINE overrides `configured`
    (AssemblerConfig.overlap_engine).  "auto" follows the backend: one GPU
    runs `device`, several run `sharded`, and the CPU backend runs
    `native`.  An unknown engine or backend is an error, never a silent
    fallback."""
    engine = env.get(ENGINE_ENV) or configured
    if engine != "auto":
        if engine not in ENGINES:
            raise ValueError("unknown overlap engine %r (expected auto or "
                             "one of %s)" % (engine, ", ".join(ENGINES)))
        return engine
    if backend == "gpu":
        return "device" if n_devices == 1 else "sharded"
    if backend == "cpu":
        return "native"
    raise ValueError("no overlap engine for backend %r; set %s"
                     % (backend, ENGINE_ENV))


class Assembler:
    def __init__(self, config: AssemblerConfig, log=print):
        self.cfg = config
        self.log = log
        self._timer = PhaseTimer(log=log)

    @property
    def timings(self):
        return self._timer.timings

    def _timed(self, name, fn, *args):
        """Silently-timed phase for bench consumers; the reference-format
        CLOCKSTART/CLOCKSTOP log blocks are emitted by the phase functions
        themselves (utils/timing.py phase_clock)."""
        with self._timer.phase(name):
            result = fn(*args)
        return result

    def _build(self, graph):
        """Run the construction phase with the overlap engine chosen by
        select_engine (all engines produce byte-identical graphs:
        tests/test_golden.py, tests/test_hybrid.py, tests/test_sharded.py).
        """
        from .utils.timing import phase_clock
        with phase_clock("buildOverlapGraphFromHashTable", log=self.log,
                         src=__file__):
            self._build_engine(graph)

    def _build_engine(self, graph):
        import os
        import jax
        configured = getattr(self.cfg, "overlap_engine", "auto")
        engine = select_engine(jax.default_backend(), len(jax.devices()),
                               os.environ, configured)
        self.engine = engine
        if engine == "native":
            if not os.environ.get("MGTPU_NO_NATIVE"):
                if graph.build_full_native():
                    return
                if (os.environ.get(ENGINE_ENV) or configured) == "native":
                    raise RuntimeError("native overlap engine unavailable")
            # no native library: the device program on the CPU backend,
            # replayed in Python when MGTPU_NO_NATIVE is set
            engine = self.engine = "device"
        if engine == "hybrid":
            # CPU scan of reads [1, a) concurrent with the device shard
            # [a, n]; canonical streams merge exactly, with global
            # cross-shard containment for mixed-length datasets
            # (graph/build.py build_hybrid).
            if graph.build_hybrid():
                return
            from .ops.device_overlap import DeviceOverlapPipeline
            pipeline = DeviceOverlapPipeline(self.dataset,
                                             self.cfg.min_overlap)
            graph.build_from_pipeline(pipeline)
        elif engine == "host":
            index = OverlapIndex(self.dataset, self.cfg.min_overlap)
            graph.build_from_index(index)
        elif engine == "sharded":
            from .parallel.sharded import ShardedOverlapPipeline
            pipeline = ShardedOverlapPipeline(self.dataset,
                                              self.cfg.min_overlap,
                                              mesh=self.cfg.mesh)
            graph.build_from_pipeline(pipeline)
        else:
            from .ops.device_overlap import DeviceOverlapPipeline
            pipeline = DeviceOverlapPipeline(self.dataset, self.cfg.min_overlap)
            graph.build_from_pipeline(pipeline)

    def run(self):
        cfg = self.cfg
        prefix = cfg.output_prefix
        t_start = time.time()
        with self._timer.phase("Dataset"):
            ds = Dataset(cfg.paired_end_files, cfg.single_end_files,
                         cfg.min_overlap, log=self.log)
        if ds.number_of_unique_reads == 0:
            # the reference segfaults in HashTable::insertDataset here; stop
            # with a labeled diagnostic instead
            from .errors import MyExit
            raise MyExit("No good reads in input; nothing to assemble.")
        graph = OverlapGraph(ds, cfg, log=self.log)
        self.dataset = ds
        self.graph = graph

        if cfg.resume_from_unitig:
            # reference resume path (main.cpp:36-42): mate pairs reloaded
            # WITHOUT contained-read marking, then graph from checkpoint.
            ds.read_mate_pairs_from_file()
            graph.read_graph_from_file(prefix + ".unitig")
            graph.sort_edges()
        else:
            # insertDataset runs before graph construction in the
            # reference (main.cpp:45-46); the device pipeline replaces the
            # string hash table with a sorted-key join, so this emits the
            # reference's table statistics from a simulation (hashstats.py)
            from .hashstats import emit_insert_dataset_log
            with self._timer.phase("insertDataset"):
                emit_insert_dataset_log(ds, cfg.min_overlap, self.log)
            self._timed("buildOverlapGraphFromHashTable", self._build, graph)
            self._timed("printDataset", ds.save_reads,
                        prefix + "_sortedReads.fasta")
            graph.sort_edges()
            self._timed("saveGraphToFile", graph.save_graph_to_file,
                        prefix + ".unitig")

        self._timed("calculateFlow", graph.calculate_flow,
                    prefix + "_flow.input", prefix + "_flow.output")
        self.log("nodes: %d edges: %d"
                 % (graph.number_of_nodes, graph.number_of_edges))
        graph.print_graph(prefix + "graph1.gdl", prefix + "contigs1.fasta")

        graph.remove_all_simple_edges_without_flow()
        graph.calculate_mean_and_sd_of_insert_size()

        BANNER = "=" * 143

        iteration = 0
        while True:
            iteration += 1
            self.log("")
            self.log(BANNER)
            self.log("FIRST LOOP ITERATION %d" % iteration)
            self.log(BANNER)
            graph.simplify_graph()
            counter = graph.find_support_by_matepairs_and_merge()
            if not (counter > 0 and iteration < cfg.loop_limit):
                break
        graph.print_graph(prefix + "graph2.gdl", prefix + "contigs2.fasta")

        iteration = 0
        while True:
            iteration += 1
            self.log("")
            self.log(BANNER)
            self.log("SECOND LOOP ITERATION %d" % iteration)
            self.log(BANNER)
            graph.simplify_graph()
            counter = graph.scaffolder()
            if not (counter > 0 and iteration < cfg.loop_limit):
                break
        graph.print_graph(prefix + "graph3.gdl", prefix + "contigs3.fasta")

        iteration = 0
        while True:
            iteration += 1
            self.log("")
            self.log(BANNER)
            self.log("THIRD LOOP ITERATION %d" % iteration)
            self.log(BANNER)
            graph.simplify_graph()
            counter = graph.resolve_nodes()
            if not (counter > 0 and iteration < cfg.loop_limit):
                break
        graph.print_graph(prefix + "graph4.gdl", prefix + "contigs4.fasta")

        self.timings["total"] = time.time() - t_start
        return graph
