"""metagenomics_tpu — an overlap-graph metagenome assembler in JAX.

A from-scratch re-design of the capabilities of abiswas-odu/metagenomics
(the Omega assembler lineage) for accelerators: bulk data-parallel phases
(read packing, canonicalization, dedup, k-mer indexing, overlap
verification, coverage/insert-size statistics) run as JAX/XLA device
programs over 2-bit-packed base arrays; the inherently sequential graph
surgery (transitive reduction replay, contraction, flow, mate-pair
merging, scaffolding) runs on host over a compact edge table, with a
clean-room min-cost-flow solver replacing the license-restricted CS2 code.

Byte-equality with the reference's staged artifacts (_sortedReads.fasta,
.unitig, graph{1..4}.gdl, contigs{1..4}.fasta) is the correctness oracle
(see tests/test_golden.py).
"""

__version__ = "0.1.0"

from .config import AssemblerConfig

__all__ = ["AssemblerConfig"]
