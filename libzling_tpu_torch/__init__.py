"""libzling_tpu_torch: the zling codec in PyTorch, with hand-written CUDA
kernels for the NVIDIA H100 (sm_90a).

A port of ``libzling_tpu``'s on-device round trip (its ``backend="tpu"``):
streams are byte-identical to the JAX package and to the native engine.
The package imports torch and never jax, and nothing of ``libzling_tpu``:
it keeps its own copies of the format tables (``tables``), the container
parser (``container``) and the native C++ engine (``native/``, built with
g++ at first use), which gives the exact Huffman length tables and the
canonical host codec the card's streams are checked against.

Public API:

    encode(data, level=0, device="cuda") -> bytes
    decode(data, device="cuda", fused=True) -> bytes
    decode_groups(data, device="cuda", group_blocks=1) -> bytes
    encode_file(src, dst, level=0), decode_file(src, dst)   # streaming
    stream_encode(src, dst, level=0, devices=None, hooks=None)
    stream_decode(src, dst, devices=None, hooks=None)

Command line (``cli.py``; stdin/stdout by default, streaming a group of
blocks at a time on every visible GPU):

    python -m libzling_tpu_torch e0..e6|d [source [target]]
        [--backend cuda|cpu|pipeline|native] [--checksum]

The block-parallel host pipeline (``pipeline.py``, the JAX package's
default backend) is a host backend, used only where it is named.
"""

from .api import decode, decode_file, encode, encode_file  # noqa: F401
from .group_decode import decode_groups  # noqa: F401
from .utils.io import stream_decode, stream_encode  # noqa: F401

__all__ = ["encode", "decode", "decode_groups", "encode_file", "decode_file",
           "stream_encode", "stream_decode"]
