"""The comparison that decides ``correct``: a sound program passes it, the
control and every fault planted in the timed path fail it.

These runs skip the harness's look for a chip and drive the rest of a run
on the CPU (every kernel's plain version) at a small size; the faults are
planted in ``libzling_tpu_torch.api``'s entries, where the window calls
them.  A cell of one chip that encodes or decodes has two such faults: an
answer altered where it is produced, and half of the work left out.  It
has no training state to leave unchanged and no exchange between chips.
"""

import pytest

from benchmark.harness import runner
from benchmark.reference import codec

CELLS = ["enwik8-e0.encode", "enwik8-e0.decode", "enwik8-e4.encode",
         "enwik8-e4.decode"]
SMALL = {"bytes": 40_000}


def cpu_port():
    return runner.Port("cpu")


def flip_one_byte(out: bytes) -> bytes:
    b = bytearray(out)
    b[len(b) // 2] ^= 0x20
    return bytes(b)


def drop_half(out: bytes) -> bytes:
    return out[:len(out) // 2]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    r = runner.run(cell, 2**40 + 3, 0.5, False, system=cpu_port,
                   corpus_override=SMALL)
    res = r["result"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert r["check_lines"] == ["check bytes_differing 0 limit 0",
                                "check calls_failed 0 limit 0",
                                "check devices_unused 0 limit 0"]
    (rate,) = [k for k in res["metrics"] if k.endswith("_MBps")]
    assert res["metrics"][rate]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", [flip_one_byte, drop_half])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_the_timed_path_is_caught(cell, fault, monkeypatch):
    from libzling_tpu_torch import api

    op = cell.split(".")[1]
    real = getattr(api, op)
    monkeypatch.setattr(api, op, lambda *a, **k: fault(real(*a, **k)))
    res = runner.run(cell, 2**40 + 4, 0.2, False, system=cpu_port,
                     corpus_override=SMALL)["result"]
    assert not res["correct"]
    assert res["checks"]["bytes_differing"]["value"] > 0


def test_a_call_that_raises_is_caught(monkeypatch):
    from libzling_tpu_torch import api

    real, seen = api.decode, []

    def boom(*a, **k):            # the warm-up call passes, the window's fail
        seen.append(1)
        if len(seen) > 1:
            raise RuntimeError("planted")
        return real(*a, **k)

    monkeypatch.setattr(api, "decode", boom)
    res = runner.run("enwik8-e0.decode", 5, 0.2, False, system=cpu_port,
                     corpus_override=SMALL)["result"]
    assert not res["correct"] and res["failed"] == res["attempted"] >= 1
    assert res["checks"]["calls_failed"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control (the reference with the MTF state and level reset at
    each block) over two blocks, the least input on which it differs."""
    r = runner.run(cell, 2**40 + 6, 0.1, False, system=runner.Control,
                   corpus_override={"bytes": codec.BLOCK_BYTES + 300_000})
    checks = r["result"]["checks"]
    assert not r["result"]["correct"]
    assert (checks["bytes_differing"]["value"] > 0
            or checks["calls_failed"]["value"] > 0)
