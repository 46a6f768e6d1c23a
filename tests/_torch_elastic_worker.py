"""One process of the 2-process ``torch.distributed`` (gloo) CPU job of
tests/test_torch_elastic.py::test_two_process_gloo_recovery:

    python _torch_elastic_worker.py <init_method> <rank> <out_prefix> \
        [finish|relabel]

Each rank runs ``distributed_encode(..., elastic=True)`` on its own CPU
"device"; on rank 1 the first ``Part.finish`` (or ``Part.relabel``, its
K5) of group 1, not the last, raises ``DeviceLost``.  Writes
``<out_prefix>.stream`` and the rank's counters as ``<out_prefix>.json``.
"""

import datetime
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from libzling_tpu_torch import _build  # noqa: E402
from libzling_tpu_torch import group_encode as ge  # noqa: E402
from libzling_tpu_torch import parallel  # noqa: E402
from libzling_tpu_torch.utils import metrics  # noqa: E402

# three groups of two blocks (one a rank); the CPU lane's route
GEOM = dict(block_size=1024, max_tokens=400)
LEVEL = 2


def data() -> bytes:
    rng = np.random.default_rng(29)
    return ((b"elastic ranks agree on a failed group " * 90)
            + bytes(rng.integers(0, 256, 1500, dtype=np.uint8))
            + (b"and both encode it again " * 40))


def main() -> None:
    init_method, rank, prefix = sys.argv[1:4]
    where = sys.argv[4] if len(sys.argv) > 4 else "finish"
    rank = int(rank)
    assert parallel.init_distributed(
        init_method, 2, rank, backend="gloo",
        timeout=datetime.timedelta(seconds=60))
    init, orig, faults = ge.Part.__init__, getattr(ge.Part, where), []
    group1 = data()[2048:2064]          # group 1's first bytes

    def init_(self, group, *a, **k):
        self._group1 = bytes(group[:16]) == group1
        init(self, group, *a, **k)

    def fault(self, *a):
        if rank == 1 and self._group1 and not faults:
            faults.append(1)
            raise _build.DeviceLost(f"injected fault: rank 1, group 1 "
                                    f"{where}")
        return orig(self, *a)

    ge.Part.__init__ = init_
    setattr(ge.Part, where, fault)
    stream = parallel.distributed_encode(data(), LEVEL, device="cpu",
                                         elastic=True, **GEOM)
    pathlib.Path(prefix + ".stream").write_bytes(stream)
    pathlib.Path(prefix + ".json").write_text(
        json.dumps(metrics.registry.snapshot()["counters"]))
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"rank {rank}: {len(stream)} bytes, faults {len(faults)}")


if __name__ == "__main__":
    main()
