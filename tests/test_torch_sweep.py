"""K4's schedule sweep (``libzling_tpu_torch.probes.sweep_tokenize``, the
counterpart of ``tools/sweep_tokenize.py``) on the CPU, at a few KiB of
the corpus: each row's unit count against the plain K4 through the level
table (the rows that are levels) and against the JAX package's K4 in
interpret mode under the same uniform schedule (d1, d2, d3, which no level
reaches); the engine's e0 counters against the e0 row's units.

Tolerance: exact equality -- unit and counter counts are integers.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from libzling_tpu.ops import tokenize_kernel as jtk
from libzling_tpu_torch.ops import tokenize_kernel as ttk
from libzling_tpu_torch.probes import sweep_tokenize as sw
from libzling_tpu_torch.tables import BLOCK_SIZE_ROLZ

SIZE = 3072
LEVEL_ROWS = {"e0 (+ lazy1 d1)": 0, "e1 (d4)": 1, "e2": 2, "e4": 4}


@functools.lru_cache(maxsize=None)
def _rows() -> tuple:
    data = sw.corpus_slice(SIZE)
    return data, tuple(sw.sweep(data, "cpu"))


def _jax_units(data: bytes, schedule) -> int:
    """The JAX K4's units under one uniform schedule, as the JAX tool
    builds its meta rows (interpret mode)."""
    ilen, max_chunks, chunk_units = len(data), 2, 4096
    stride = (-(-chunk_units // jtk.STAGE_UNITS) + 1) * jtk.STAGE_UNITS
    rows = max(32, -(-(ilen + jtk.SLAB_WORDS + 512) // 4096) * 32)
    flat = np.zeros(rows * 128, np.uint8)
    flat[:ilen] = np.frombuffer(data, np.uint8)
    meta = np.zeros((1, 8, 256), np.int32)
    meta[0, 0, :3] = ilen, BLOCK_SIZE_ROLZ, chunk_units
    meta[0, 3:6, :] = np.asarray(schedule, np.int32)[:, None]
    _a, _b, stat = jtk._tokenize_call(
        jnp.asarray(meta), jnp.asarray(flat[None]), interpret=True,
        chunk_stride=stride, max_chunks=max_chunks, block_rows=rows)
    stat = np.asarray(stat)
    assert stat[0, 6, 1] == 0 and stat[0, 6, 2] == ilen
    return int(stat[0, 0, :max_chunks].sum())


def test_rows_are_the_jax_tools():
    data, rows = _rows()
    assert len(data) == SIZE
    assert [(r["row"], r["schedule"]) for r in rows] == [
        ("d1 (base + step0)", (1, 0, 0)), ("d2 (+ step1)", (2, 0, 0)),
        ("e0 (+ lazy1 d1)", (2, 1, 0)), ("d3 (+ loop step)", (3, 1, 0)),
        ("e1 (d4)", (4, 1, 0)), ("e2", (6, 2, 0)), ("e4", (16, 4, 2))]
    # no time from the CPU
    assert all("ms" not in r for r in rows)


@pytest.mark.parametrize("name", sorted(LEVEL_ROWS))
def test_level_rows_equal_the_plain_k4(name):
    data, rows = _rows()
    units = {r["row"]: r["units"] for r in rows}[name]
    out = ttk.tokenize_block(data, [LEVEL_ROWS[name]] * 2, BLOCK_SIZE_ROLZ,
                             2, 4096, device="cpu")
    assert out[8] == 0 and units == int(out[4].sum())


@pytest.mark.parametrize("name", ["d1 (base + step0)", "d2 (+ step1)",
                                  "d3 (+ loop step)"])
def test_other_rows_equal_the_jax_kernel(name):
    data, rows = _rows()
    row = {r["row"]: r for r in rows}[name]
    assert row["units"] == _jax_units(data, row["schedule"])


def test_engine_counters_tokenize_as_k4():
    # the engine's e0 tokens are K4's units: one chunk's two head bytes,
    # then a match, a word hit or a literal each
    data, rows = _rows()
    c = sw.engine_counters(data)
    assert 2 + c["match_succ"] + c["word_hits"] + c["literals"] \
        == rows[2]["units"]
    assert c["bucket_updates"] == c["match_succ"] + c["match_fail"]
    assert c["chain_steps"] > 0
