"""The decode of tests/test_torch_pipeline.py::
test_decoder_bounds_its_chunks_in_flight, in a process of its own (a
decoder that deadlocks leaves pool threads that would keep the test
process from exiting):

    python _torch_pipeline_worker.py <stream file>

Decodes the stream with ``pipeline.ParallelDecoder`` while chunk 0's
entropy job waits until the submissions have stopped for 50 ms and every
other job submitted has finished (at most ``WAIT_S``).  Prints one JSON
line: the decoded bytes' hex digest, the jobs submitted, the jobs chunk 0
waited for, and whether its wait timed out.
"""

import hashlib
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from libzling_tpu_torch import pipeline  # noqa: E402

WAIT_S = 50
FIRST = 13          # chunk 0's payload offset: after its flag and header


def main() -> None:
    stream = pathlib.Path(sys.argv[1]).read_bytes()
    dec = pipeline.ParallelDecoder()
    submitted, seen = [], {"timed_out": False}
    plain_submit, plain_job = dec.pool.submit, dec._entropy_chunk

    def submit(fn, *args):
        fut = plain_submit(fn, *args)
        submitted.append(fut)
        return fut

    def job(in_arr, off, olen, rlen, tokens):
        if off == FIRST:
            deadline = time.monotonic() + WAIT_S
            n, since = -1, time.monotonic()
            while True:
                if len(submitted) != n:
                    n, since = len(submitted), time.monotonic()
                elif time.monotonic() - since > 0.05 and \
                        all(f.done() for f in submitted[1:n]):
                    break
                if time.monotonic() > deadline:
                    seen["timed_out"] = True
                    break
                time.sleep(0.001)
            seen["waited_for"] = n - 1
        return plain_job(in_arr, off, olen, rlen, tokens)

    dec.pool.submit, dec._entropy_chunk = submit, job
    out = dec.decode(stream)
    dec.close()
    print(json.dumps(dict(sha256=hashlib.sha256(out).hexdigest(),
                          submitted=len(submitted), workers=dec.workers,
                          **seen)), flush=True)


if __name__ == "__main__":
    main()
