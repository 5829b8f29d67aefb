"""Observability utilities: per-phase timing, memory, profiler traces.

Replacement for the reference's CLOCKSTART/CLOCKSTOP macro pair
and checkMemoryUsage() (MetaGenomics/Common.h:52-76), which print each major
function's wall time and VmData delta.  The same stdout format is kept so
per-phase statistics diff directly against reference logs, plus an optional
jax.profiler trace per phase (env MGTPU_PROFILE_DIR) for real device
timelines.
"""

from .timing import check_memory_usage, phase_clock, PhaseTimer
from .jax_cache import compile_cache_dir, enable_compile_cache

__all__ = ["check_memory_usage", "phase_clock", "PhaseTimer",
           "compile_cache_dir", "enable_compile_cache"]
