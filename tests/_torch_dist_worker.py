"""One process of the 2-process ``torch.distributed`` (gloo) CPU job of
tests/test_torch_distributed.py:

    python _torch_dist_worker.py <init_method> <world_size> <rank> <out_prefix>

Each rank runs ``distributed_encode`` and ``distributed_decode`` on its
own CPU "device" and writes ``<out_prefix>.stream`` and
``<out_prefix>.decoded``; the test holds them to ``spec.encode``, to the
data and to the other rank's.
"""

import datetime
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from libzling_tpu_torch import parallel  # noqa: E402

# five blocks: groups of two, then one that leaves rank 1 without a run
GEOM = dict(block_size=1536, max_tokens=500)


def data() -> bytes:
    rng = np.random.default_rng(23)
    return ((b"distributed zling over two processes " * 80)
            + bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
            + (b"tail text recovers the level " * 40))


def main() -> None:
    init_method, world, rank, prefix = sys.argv[1:5]
    assert parallel.init_distributed(
        init_method, int(world), int(rank), backend="gloo",
        timeout=datetime.timedelta(seconds=60))
    assert parallel.init_distributed()          # idempotent
    d = data()
    stream = parallel.distributed_encode(d, 1, device="cpu", **GEOM)
    out = parallel.distributed_decode(stream, group_blocks=1, device="cpu")
    pathlib.Path(prefix + ".stream").write_bytes(stream)
    pathlib.Path(prefix + ".decoded").write_bytes(out)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"rank {rank}: {len(d)} -> {len(stream)} -> {len(out)}")


if __name__ == "__main__":
    main()
