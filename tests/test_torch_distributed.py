"""The port's lanes over ``torch.distributed``: a 2-process ``gloo`` job on
the CPU (``tests/_torch_dist_worker.py``), the counterpart of
tests/test_multihost.py.  Both ranks' ``distributed_encode`` streams must
equal ``spec.encode`` at the workers' geometry and each other, and both
ranks' ``distributed_decode`` must give back the data.

A hang fails fast: the process group times out after 60 s, the workers
are killed 120 s after their start, and nothing is retried.

Tolerance: exact equality -- streams and outputs are bytes.
"""

from __future__ import annotations

import pathlib
import socket
import subprocess
import sys
import time

import pytest

from libzling_tpu import spec

from . import _torch_dist_worker as worker

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_encode_and_decode(tmp_path):
    init = f"tcp://127.0.0.1:{_free_port()}"
    prefixes = [str(tmp_path / f"rank{r}") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(worker.__file__)), init, "2",
         str(r), prefixes[r]], cwd=str(REPO), stdout=subprocess.PIPE,
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
    data = worker.data()
    want = spec.encode(data, 1, **worker.GEOM)
    for prefix in prefixes:
        assert pathlib.Path(prefix + ".stream").read_bytes() == want
        assert pathlib.Path(prefix + ".decoded").read_bytes() == data


def test_nothing_configured(monkeypatch):
    # no init_method and no env:// variables: no group, nothing started
    import torch.distributed as dist

    from libzling_tpu_torch import parallel

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert parallel.init_distributed() is False
    assert parallel.init_distributed("tcp://127.0.0.1:1", world_size=1,
                                     rank=0) is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        parallel.distributed_encode(b"abc", 0, device="cpu")
    with pytest.raises(RuntimeError):
        parallel.distributed_decode(spec.encode(b"abc", 0), device="cpu")
