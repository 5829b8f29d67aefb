"""Device-side (JAX/XLA) bulk kernels.

All per-base, per-read and per-candidate work is expressed over fixed-shape
padded arrays of 2-bit base codes so XLA can fuse and tile it; variable-length
semantics are carried by explicit length vectors and masks.
"""

from .packing import (
    PAD_CODE,
    ascii_to_codes,
    codes_to_ascii,
    reverse_complement_codes,
    canonicalize_codes,
    qc_mask,
    pack_sort_limbs,
)
from .overlap import verify_candidates, CandidateBatch

__all__ = [
    "PAD_CODE",
    "ascii_to_codes",
    "codes_to_ascii",
    "reverse_complement_codes",
    "canonicalize_codes",
    "qc_mask",
    "pack_sort_limbs",
    "verify_candidates",
    "CandidateBatch",
]
