"""The lanes' ``elastic`` group recovery on the CPU: ``mesh_encode(...,
elastic=True)`` with a lost device (``DeviceLost``, injected by
``chip_smoke.PartFaults``) in one group's ``Part.finish``, its dispatch
(``Part.__init__``) or its K5 (``Part.relabel``) must still give
``spec.encode``'s stream, at the CPU-lane route's geometry
(``max_tokens`` 400) and at the native route's (``max_tokens`` =
``BLOCK_SIZE_ROLZ``); a second failure in a row, and any fault of the
port's own (a plain RuntimeError), propagate; ``native.encode_from``
against the JAX package's ``_host_encode_group`` from the same carried
state; and 2-process gloo jobs with a fault on rank 1
(``tests/_torch_elastic_worker.py``).  The counterpart of
tests/test_multihost.py::test_elastic_group_recovery.

Tolerance: exact equality -- streams, MTF states and levels are bytes and
integers; ``enc.group_failover`` equals the number of failed groups.
"""

from __future__ import annotations

import functools
import json
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from chip_smoke import PartFaults
from libzling_tpu import spec
from libzling_tpu.ops import mtf as jmtf
from libzling_tpu.parallel import mesh as jmesh
from libzling_tpu_torch import _build
from libzling_tpu_torch.native import engine
from libzling_tpu_torch.ops import mtf as tmtf
from libzling_tpu_torch.parallel import mesh_encode
from libzling_tpu_torch.tables import BLOCK_SIZE_ROLZ
from libzling_tpu_torch.utils import metrics

from . import _torch_elastic_worker as worker

REPO = pathlib.Path(__file__).resolve().parent.parent
LEVEL = 4
BLOCK = 1024
ROUTES = {"cpu lane": 400, "native": BLOCK_SIZE_ROLZ}
TAG = 11            # every group starts with b"<group NN> "


def _data() -> bytes:
    # five groups of two 1,024-byte blocks (the last one and a half); the
    # first holds random bytes in both blocks and ends in them (the level
    # drops inside a block, and the second group enters at level 0), the
    # others are text (their look-aheads hold: a fault in their dispatch
    # is met when the group is consumed)
    rng = np.random.default_rng(41)
    words = [b"elastic", b"group", b"recovery", b"carry", b"state", b"\n"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 3000))
    noise = bytes(rng.integers(0, 256, 1037, dtype=np.uint8))
    body = 2 * BLOCK - TAG
    bodies = [text[:700] + noise[:700] + text[700:1000] + noise[700:]]
    bodies += [text[1000 + k * body:1000 + (k + 1) * body] for k in range(3)]
    bodies.append(text[1000 + 3 * body:1000 + 3 * body + 1536])
    return b"".join(b"<group %02d> " % g + b for g, b in enumerate(bodies))


def faults(where: dict, error=None) -> PartFaults:
    """Each group of ``where`` fails once, at its ``"dispatch"``
    (``Part.__init__``), ``"relabel"`` or ``"finish"``, raising ``error``
    (default ``DeviceLost``); K4's and K5's groups recorded."""
    return PartFaults(_data(), 2 * BLOCK, where, torch.device("cpu"), error)


@functools.lru_cache(maxsize=None)
def _spec(max_tokens: int) -> bytes:
    return spec.encode(_data(), LEVEL, block_size=BLOCK,
                       max_tokens=max_tokens)


def test_data_covers_the_cases():
    # five groups; the first exits at level 0, so the second enters there
    data = _data()
    assert len(data) == 4 * 2 * BLOCK + TAG + 1536
    assert [data[g * 2 * BLOCK:g * 2 * BLOCK + TAG] for g in range(5)] == \
        [b"<group %02d> " % g for g in range(5)]
    for mt in ROUTES.values():
        assert spec.decode(_spec(mt)) == data
    pad = bytes(spec.SENTINEL_LEN + 128)
    _, _, _, exit0 = jmesh._host_encode_group(
        [np.frombuffer(data[b * BLOCK:(b + 1) * BLOCK] + pad, np.uint8)
         for b in range(2)], [BLOCK] * 2, LEVEL, LEVEL,
        *map(np.asarray, jmtf.initial_state()), 400)
    assert exit0 == 0


CASES = {
    "finish first": {0: "finish"},
    "finish middle": {2: "finish"},
    "finish second (enters at level 0)": {1: "finish"},
    "finish last": {4: "finish"},
    "finish two in a row": {1: "finish", 2: "finish"},
    "dispatch first": {0: "dispatch"},
    "dispatch middle": {2: "dispatch"},
    "dispatch last": {4: "dispatch"},
    "relabel middle": {2: "relabel"},
    "relabel last": {4: "relabel"},
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_elastic_recovery_keeps_the_stream(case, route):
    where = CASES[case]
    metrics.registry.reset()
    if case == "finish two in a row":
        # the group after a failover must finish on the device: the second
        # failure propagates, and the host never carries the stream on
        with faults(where) as f, pytest.raises(_build.DeviceLost,
                                               match="group 2 finish"):
            mesh_encode(_data(), LEVEL, ["cpu"] * 2, block_size=BLOCK,
                        max_tokens=ROUTES[route], elastic=True)
        assert f.faults == {}
        assert metrics.registry.snapshot()["counters"].get(
            "enc.group_failover") == 1
        return
    with faults(where) as f:
        got = mesh_encode(_data(), LEVEL, ["cpu"] * 2, block_size=BLOCK,
                          max_tokens=ROUTES[route], elastic=True)
    assert got == _spec(ROUTES[route])
    assert f.faults == {}, "a fault was never reached"
    counters = metrics.registry.snapshot()["counters"]
    assert counters.get("enc.group_failover", 0) == len(where)
    # the device path resumed: K4 and K5 ran for every group after the
    # last failed one
    last = max(where)
    assert set(range(last + 1, 5)) <= set(f.k4) & set(f.k5)
    if last < 4 and where[last] != "dispatch":
        # the look-ahead chained from the failed group went again
        assert counters.get("enc.pipeline_redispatch", 0) >= 1


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_dropped_lookahead_keeps_its_fault(route):
    # group 1's look-ahead is chained from group 0's predicted level, but
    # group 0 exits at level 0: the look-ahead is dropped with the error
    # of its dispatch, and group 1 is dispatched again -- nothing fails over
    metrics.registry.reset()
    with faults({1: "dispatch"}) as f:
        got = mesh_encode(_data(), LEVEL, ["cpu"] * 2, block_size=BLOCK,
                          max_tokens=ROUTES[route], elastic=True)
    assert got == _spec(ROUTES[route]) and f.faults == {}
    counters = metrics.registry.snapshot()["counters"]
    assert counters.get("enc.group_failover", 0) == 0
    assert counters.get("enc.pipeline_redispatch", 0) >= 1


@pytest.mark.parametrize("where", ["finish", "dispatch"])
def test_without_elastic_the_fault_propagates(where):
    metrics.registry.reset()
    with faults({1: where}), pytest.raises(RuntimeError,
                                           match="injected fault"):
        mesh_encode(_data(), LEVEL, ["cpu"] * 2, block_size=BLOCK,
                    max_tokens=400)
    assert metrics.registry.snapshot()["counters"].get(
        "enc.group_failover", 0) == 0


@pytest.mark.parametrize("where", ["finish", "dispatch", "relabel"])
def test_a_fault_of_the_port_never_fails_over(where):
    # a build, launch or kernel fault (any error but a lost device)
    # propagates with elastic on, and nothing is counted
    metrics.registry.reset()
    with faults({2: where}, RuntimeError), \
            pytest.raises(RuntimeError, match="injected fault") as e:
        mesh_encode(_data(), LEVEL, ["cpu"] * 2, block_size=BLOCK,
                    max_tokens=400, elastic=True)
    assert not isinstance(e.value, _build.DeviceLost)
    assert metrics.registry.snapshot()["counters"].get(
        "enc.group_failover", 0) == 0


def test_which_errors_mean_a_lost_device():
    lost = torch.AcceleratorError("CUDA error: uncorrectable ECC error")
    lost.error_code = 214
    fault = torch.AcceleratorError("CUDA error: an illegal memory access")
    fault.error_code = 700
    assert _build.device_lost(_build.DeviceLost("x"))
    assert _build.device_lost(lost)
    assert not _build.device_lost(fault)
    assert not _build.device_lost(RuntimeError("nvcc failed"))
    assert not _build.device_lost(ValueError("bad stream"))
    for code in sorted(_build.LOST_CODES):
        with pytest.raises(_build.DeviceLost):
            _build.check(code, "zlt_tokenize")
    for code in (1, 700, 719):
        with pytest.raises(RuntimeError) as e:
            _build.check(code, "zlt_tokenize")
        assert not _build.device_lost(e.value)
    _build.check(0, "zlt_tokenize")


def _carried_case():
    # a prior group of one chunk of mostly random bytes (its exit level is
    # 0), then a 300,000-byte block: 262,144 random bytes fill
    # its first chunk (the entry chunk, coded at the carried level), so
    # the level drops inside the block and the text after recovers it
    rng = np.random.default_rng(17)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"\n"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 9000))
    prior = text[:300] + bytes(rng.integers(0, 256, 20000, np.uint8))
    block = bytes(rng.integers(0, 256, 270000, np.uint8)) + text[:30000]
    return prior, block + text[30000:40000]


@pytest.mark.parametrize("level", [0, 4, 6])
def test_encode_from_equals_jax_host_encode_group(level):
    prior, group = _carried_case()
    bs = 300000
    pad = bytes(spec.SENTINEL_LEN + 128)

    def jax_group(data, entry, r2s, s2r):
        blocks = [data[i:i + bs] for i in range(0, len(data), bs)]
        return jmesh._host_encode_group(
            [np.frombuffer(b + pad, np.uint8) for b in blocks],
            [len(b) for b in blocks], level, entry, r2s, s2r,
            BLOCK_SIZE_ROLZ)

    # the prior group from the stream's start, then the group from the
    # carry the prior one left: bytes, exit state and exit level each time
    init = tmtf.state_to_bytes(tmtf.initial_state("cpu"))
    r2s, s2r = map(np.asarray, jmtf.initial_state())
    carry = (init, level)
    for data in (prior, group):
        want, r2s, s2r, exit_level = jax_group(data, carry[1], r2s, s2r)
        got, state, got_level = engine.encode_from(data, level, *carry, bs)
        assert got == want
        assert state == tmtf.state_to_bytes(tmtf.state_from_jax(r2s, s2r))
        assert got_level == exit_level
        carry = (state, got_level)
        if data is prior:
            assert got_level == 0 and state != init


def test_encode_from_checks_its_arguments():
    state = tmtf.state_to_bytes(tmtf.initial_state("cpu"))
    for args in ((7, state, 0, 1024), (0, state, 7, 1024),
                 (0, state[:-1], 0, 1024), (0, state, 0, 0),
                 (0, state, 0, engine.BLOCK_BYTES + 1)):
        with pytest.raises(ValueError):
            engine.encode_from(b"abc", *args)
    assert engine.encode_from(b"", 3, state, 3, 1024) == (b"", state, 3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_recovery(tmp_path):
    # rank 1's Part.finish of group 1 raises once: both ranks agree, both
    # encode the group again on the host, both return spec's stream
    _gloo_job(tmp_path, "finish")


def test_two_process_gloo_recovery_from_k5(tmp_path):
    # rank 1's K5 of group 1 (not the last) raises: rank 1 still hands its
    # input state on, so the chain's send/recv and the exit broadcast pair
    # up, and the ranks agree before their next collective
    _gloo_job(tmp_path, "relabel")


def _gloo_job(tmp_path, where: str) -> None:
    init = f"tcp://127.0.0.1:{_free_port()}"
    prefixes = [str(tmp_path / f"rank{r}") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(worker.__file__)), init, str(r),
         prefixes[r], where], cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    deadline = time.monotonic() + 120
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
                .decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("the 2-process job did not end within 120 s:\n"
                    + "\n".join(logs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    want = spec.encode(worker.data(), worker.LEVEL, **worker.GEOM)
    for prefix in prefixes:
        assert pathlib.Path(prefix + ".stream").read_bytes() == want
        counters = json.loads(pathlib.Path(prefix + ".json").read_text())
        assert counters.get("enc.group_failover") == 1, counters
