"""Engine choice, compile-cache location and the mock-community generator:
the pure-Python pieces the GPU path rests on, checked on the CPU."""

import os

import numpy as np
import pytest

from metagenomics_tpu.assembler import select_engine
from metagenomics_tpu.utils.jax_cache import (CACHE_ENV, DEFAULT_CACHE,
                                              compile_cache_dir)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,n_devices,env,configured,want", [
    ("gpu", 1, {}, "auto", "device"),
    ("gpu", 4, {}, "auto", "sharded"),
    ("cpu", 1, {}, "auto", "native"),
    ("cpu", 8, {}, "auto", "native"),
    ("gpu", 1, {"MGTPU_OVERLAP_ENGINE": "native"}, "auto", "native"),
    ("gpu", 4, {"MGTPU_OVERLAP_ENGINE": "device"}, "sharded", "device"),
    ("cpu", 1, {}, "hybrid", "hybrid"),
    ("gpu", 1, {"MGTPU_OVERLAP_ENGINE": ""}, "auto", "device"),
])
def test_select_engine(backend, n_devices, env, configured, want):
    assert select_engine(backend, n_devices, env, configured) == want


@pytest.mark.parametrize("env,configured,backend", [
    ({"MGTPU_OVERLAP_ENGINE": "gpu"}, "auto", "gpu"),
    ({}, "fastest", "gpu"),
    ({}, "auto", "metal"),
])
def test_select_engine_rejects_unknown(env, configured, backend):
    with pytest.raises(ValueError):
        select_engine(backend, 1, env, configured)


@pytest.mark.parametrize("env,want", [
    ({CACHE_ENV: "/var/cache/xla"}, "/var/cache/xla"),
    ({}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(env, want):
    assert compile_cache_dir(env) == want
    assert DEFAULT_CACHE == os.path.join(REPO, ".jax_cache")


def test_mock_community_is_seeded_2x150_pairs(tmp_path):
    from metagenomics_tpu.tools.mock_community import (mock_community,
                                                       write_fasta)
    kw = dict(n_genomes=5, genome_len=(3_000, 6_000))
    a = mock_community(300, 11, **kw)
    assert a.shape == (600, 150) and a.dtype == np.uint8
    assert a.max() <= 3
    np.testing.assert_array_equal(a, mock_community(300, 11, **kw))
    assert not np.array_equal(a, mock_community(300, 12, **kw))
    # error-free, fixed 270 bp inserts: the mates are the two ends of one
    # fragment on opposite strands, so (on either strand) the first mate's
    # last 30 bases are the first 30 of the second mate's reverse
    # complement
    clean = mock_community(300, 11, sub_rate=0.0, insert_sd=0, **kw)
    rc2 = 3 - clean[1::2, ::-1]
    np.testing.assert_array_equal(clean[0::2, 120:], rc2[:, :30])
    path = tmp_path / "m.fasta"
    write_fasta(a[:4], str(path))
    lines = path.read_text().splitlines()
    assert lines[0::2] == [">0", ">1", ">2", ">3"]
    assert all(len(s) == 150 and set(s) <= set("ACGT")
               for s in lines[1::2])
