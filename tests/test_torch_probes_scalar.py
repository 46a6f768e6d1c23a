"""The card's scalar-cost probes (their plain versions, on the CPU) against
the JAX package's TPU probe ``tools/probe_scalar_cost.py``.

The tool runs as it is through ``tests/_probe_tools.py``: interpret-mode
``pallas_call``, with its ``N`` set to 8448 (past 8192, so that ``v6``
flushes its carry and ``v11`` refills and flushes).  Interpret mode fills
uninitialised int32 scratch with -2**31, whose low bits are 0; instead,
the scratch a body reads before it writes starts from the same seeded
contents on both sides -- random words, and for ``v10`` and the match
layers K1-shaped decode tables (``decode_tables``) -- and ``v6``'s table
from zeros, as on the card.  Every body is held to its plain version on
word 0 (the only result the TPU probe returns) and on the final contents
of its scratch arrays: the tables ``v2``, ``v3``, ``v5`` and ``v6``
write, ``v10``'s token buffer, ``v11``'s slab and staging buffer,
``mk_dma``'s shared buffer, and the match body's slab, MTF rows,
word-MRU, ring heads, ring and output.  The ``+puts`` layer of the match body, which the card has no counterpart for,
is held to the plain version without it.  The TPU's ``+ring``,
``+mtf/mru`` and ``+puts`` layers write their staging row into output rows
that nothing reads, so their output is not compared.

Tolerance: exact equality -- every result is an integer.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libzling_tpu_torch.probes import scalar_cost as sc
from tests._probe_tools import load_tool

N = 8448
SEED = 2
MATCH = {"match: bitread+idx": 0, "match: +ring": 1, "match: +mtf/mru": 3,
         "match: +puts": 3, "match: +tail": 7, "match: +copy (full)": 15}
DMA = {label: (nw, toward) for label, nw, toward in sc.DMA}
# the tool's pallas_calls, in the order main, main2 and main3 make them
CASES = [*sc.LOOP_BODIES, "v10", "v11", *DMA, *MATCH]


def _init(name: str) -> torch.Tensor:
    """The scratch body ``name`` starts from, as the plain version takes
    it; global buffers the tool passes in are its zeros."""
    if name in sc.LOOP_BODIES:
        return sc.seeded_init(sc.LOOP_BODIES[name][1], SEED, "cpu")
    if name == "v10":
        return torch.cat([sc.seeded_init(4096, SEED, "cpu"),
                          sc.decode_tables(SEED, "cpu")])
    if name == "v11":
        return torch.cat([sc.zero_init(sc.HBM, "cpu"),
                          sc.seeded_init(4096 + 8192, SEED, "cpu")])
    if name in DMA:
        nw = DMA[name][0]
        return torch.cat([sc.zero_init(64 * nw, "cpu"),
                          sc.seeded_init(nw, SEED, "cpu")])
    return sc.decode_tables(SEED, "cpu")


def _seeds(name: str) -> dict:
    """{scratch index of the TPU body: its first contents}."""
    x = _init(name).numpy()
    if name in ("v2", "v3", "v4", "v5"):
        return {0: x}
    if name == "v6":
        return {0: np.zeros(sc.VM, np.int32)}
    if name == "v10":
        return {0: x[:4096], 1: x[4096:8192], 2: x[8192:]}
    if name == "v11":
        return {0: x[sc.HBM:sc.HBM + 4096], 1: x[sc.HBM + 4096:]}
    if name in DMA:
        return {0: x[64 * DMA[name][0]:]}
    if name in MATCH:
        return {1: x[:4096], 2: x[4096:]}
    return {}


def _state(name: str) -> dict:
    """{key of the plain version's state: scratch index of the TPU body}."""
    if name in ("v2", "v3"):
        return {"s": 0}
    if name in ("v5", "v6"):
        return {"vm": 0}
    if name == "v10":
        return {"obuf": 3}
    if name == "v11":
        return {"slab": 0, "obuf": 1}
    if name in DMA:
        return {"smem": 0}
    if name in MATCH:
        out = {"out": 8} if MATCH[name] & 12 else {}
        return dict(slab=0, mtf=3, mru=4, head=5, ring=7, **out)
    return {}


def _plain(name: str):
    x = _init(name)
    if name in sc.LOOP_BODIES:
        return sc.loop_body(name, N, x)
    if name == "v10":
        return sc.entropy_body(N, x)
    if name == "v11":
        return sc.dma_whens(N, x)
    if name in DMA:
        return sc.dma_copy(sc.ND, *DMA[name], x)
    return sc.match_body(MATCH[name], N // 4, x)


@pytest.fixture(scope="module")
def tool_run():
    mod, results = load_tool("probe_scalar_cost",
                             lambda k: _seeds(CASES[k]))
    mod.N = N
    mod.main()
    mod.main2()
    mod.main3()
    assert len(results) == len(CASES)
    return dict(zip(CASES, results))


@pytest.mark.parametrize("name", CASES)
def test_plain_equals_tpu_probe(tool_run, name):
    word0, finals = tool_run[name]
    got = _plain(name)
    assert word0 != 0 and got.word0 == word0
    for key, k in _state(name).items():
        want = finals[k].astype(np.int64)
        assert np.array_equal(np.asarray(got.state[key], np.int64), want), key


def test_seeded_state_reaches_both_words():
    # the card checks also run from random scratch: there both words must
    # depend on it (with zeros several bodies return 0, 0)
    for row, name, _, call in sc.cases(4096, "cpu", seed=1):
        if row in ("PS0-PS6", "PS10", "PS11", "PS20") and name[:2] not in (
                "v0", "v1", "v6"):
            zero = next(c for r, nm, _, c in sc.cases(4096, "cpu")
                        if nm == name)()
            assert call().word1 != zero.word1, name
