"""The card's tokenizer-cost probes (their plain versions, on the CPU)
against the JAX package's TPU probe ``tools/probe_tokenize_cost.py``.

The tool reads its N from ``sys.argv[1]`` and sets the JAX compilation
cache for the whole process when it is imported, so it is imported with
``sys.argv`` patched (N = 16) and both cache settings are put back at
once, before anything compiles; then it runs through
``tests/_probe_tools.py`` (interpret-mode ``pallas_call``, each compiled
function's first result recorded), and its ``main`` runs ``serial3_kernel``
and the nine ``build_kernel`` configurations.  ``serial3_kernel``'s table
starts from a seeded random table on both sides (interpret mode would
leave it at -2**31, whose low bits are 0, so the chain would read row 0
and sum to 0).  Each is held to its plain version on word 0.

Tolerance: exact equality -- every result is an integer.
"""

from __future__ import annotations

import sys

import pytest
import torch

import jax

from libzling_tpu_torch.probes import tokenize_cost as tc
from tests._probe_tools import load_tool

N = 16
TABLE = tc.seeded_table(256, 3, "cpu")        # serial3's (256, 128) table
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def tool_run():
    before = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    argv = sys.argv
    sys.argv = ["probe_tokenize_cost.py", str(N)]
    try:
        mod, results = load_tool(
            "probe_tokenize_cost",
            lambda k: {1: TABLE.numpy()} if k == 0 else {})
    finally:
        sys.argv = argv
        for k, v in before.items():
            jax.config.update(k, v)
    after = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    mod.main()
    names = ["serial3"] + [c[0] for c in tc.CONFIGS]
    assert len(results) == len(names)
    return dict(zip(names, (r[0] for r in results))), before, after


def test_tool_import_leaves_the_cache_settings(tool_run):
    _, before, after = tool_run
    assert after == before


@pytest.mark.parametrize("name", ["serial3"] + [c[0] for c in tc.CONFIGS])
def test_plain_equals_tpu_probe(tool_run, name):
    results = tool_run[0]
    if name == "serial3":
        got = tc.serial3(N, TABLE)
        assert got.word0 != 0
    else:
        k = [c[0] for c in tc.CONFIGS].index(name)
        got = tc.unit_body(k, N, tc.default_block("cpu"))
    assert got.word0 == results[name]


def test_deeper_walk_and_block_change_the_words():
    # `depth` and the block's bytes reach the plain version (the TPU probe
    # has depth 1 and a uniform block)
    blk = tc.default_block("cpu")
    one = tc.unit_body(2, 2048, blk)
    assert tc.unit_body(2, 2048, blk, depth=4).word1 != one.word1
    rnd = [c for r, nm, _, c in tc.cases(2048, "cpu", seed=29)
           if nm == "... +whens(taken)"][0]()
    assert rnd != tc.unit_body(4, 2048, blk)


def test_serial3_rows_at_k4_size():
    # at K4's footprint (21,504 rows, not a power of two) a word's row is
    # the high half of word x rows: inside the table, and the first load's
    # rows spread over it
    rows = tc.K4_ROWS
    assert rows & (rows - 1)
    firsts = {tc.row_of(i * tc.SPREAD, rows) for i in range(4096)}
    assert max(firsts) < rows and len(firsts) > 3500
    assert tc.row_of(0xFFFFFFFF, rows) == rows - 1
    assert [tc.row_of(x, 256) for x in (5, 256 + 7, -1)] == [5, 7, 255]
