"""The port stands alone: it imports nothing of ``libzling_tpu``, and its own
copies of the format tables, the container parser and the native engine
equal the JAX package's.

Tolerance: exact equality -- tables, streams and code lengths are integers
and bytes.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from libzling_tpu import container as jcontainer
from libzling_tpu import spec
from libzling_tpu import tables as jtables
from libzling_tpu.native import engine as jengine
from libzling_tpu_torch import container, tables
from libzling_tpu_torch.native import engine

REPO = pathlib.Path(__file__).resolve().parent.parent
LEVELS = range(7)
COPIED = sorted(n for n in vars(tables) if n.isupper())


def _mixed(seed: int = 3) -> bytes:
    # text with random bytes between: the adaptive level drop fires
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta",
             b"theta", b"kappa", b"lambda", b"\n"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 6000))
    noise = bytes(rng.integers(0, 256, 9000, dtype=np.uint8))
    return text[:20000] + noise + text[20000:]


def test_importing_the_port_loads_no_jax_package():
    code = """
import importlib, importlib.util, pkgutil, sys
import libzling_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, "libzling_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
       or k == "libzling_tpu" or k.startswith("libzling_tpu.")]
print(len([k for k in sys.modules if k.startswith("libzling_tpu_torch.")]),
      bad)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True, timeout=300, cwd=REPO)
    n, bad = r.stdout.split(" ", 1)
    assert int(n) > 10 and bad.strip() == "[]", r.stdout


@pytest.mark.parametrize("pkg,modules", [
    ("parallel", {"mesh", "decode_mesh", "distributed"}),
    ("utils", {"metrics"}),
])
def test_lanes_and_utils_load_no_jax_package(pkg, modules):
    # each module of the subpackage imported alone, in a fresh interpreter
    code = f"""
import importlib, json, pkgutil, sys
import libzling_tpu_torch.{pkg} as p
names = sorted(m.name for m in pkgutil.iter_modules(p.__path__))
bad = set()
for n in names:
    importlib.import_module("libzling_tpu_torch.{pkg}." + n)
    bad |= {{k for k in sys.modules if k == "jax" or k.startswith("jax.")
            or k == "libzling_tpu" or k.startswith("libzling_tpu.")}}
print(json.dumps([names, sorted(bad)]))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True, timeout=300, cwd=REPO)
    names, bad = json.loads(r.stdout)
    assert set(names) == modules and bad == [], r.stdout


@pytest.mark.parametrize("name", COPIED)
def test_tables_equal_the_jax_package(name):
    mine, theirs = getattr(tables, name), getattr(jtables, name)
    if isinstance(mine, np.ndarray):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    else:
        assert mine == theirs


@pytest.mark.parametrize("level", LEVELS)
def test_container_parse_equals_the_jax_package(level):
    # small geometry: several blocks of several chunks each
    stream = spec.encode(_mixed(level)[:12000], level, block_size=4096,
                         max_tokens=700)
    chunks, sizes = container.parse(stream)
    jchunks, jsizes = jcontainer.parse(stream)
    assert sizes == jsizes and len(chunks) > len(sizes) > 2
    assert [tuple(c) for c in chunks] == [tuple(c) for c in jchunks]
    for a, b in zip(container.unpack_length_tables(chunks),
                    jcontainer.unpack_length_tables(jchunks)):
        if isinstance(a, list):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    for bad in (stream[:-1], b"\x02" + stream[1:]):
        with pytest.raises(ValueError):
            container.parse(bad)
        with pytest.raises(ValueError):
            jcontainer.parse(bad)


@pytest.mark.parametrize("level", LEVELS)
def test_native_engine_equals_the_jax_package(level):
    data = _mixed(level)
    stream = engine.encode(data, level)
    assert stream == jengine.encode(data, level)
    assert engine.decode(stream) == data
    with pytest.raises(ValueError):
        engine.decode(stream[:-1])


@pytest.mark.parametrize("max_len,n", [(15, 514), (8, 32)])
def test_native_length_tables_equal_the_jax_package(max_len, n):
    from libzling_tpu.ops import huffman as jh

    rng = np.random.default_rng(max_len)
    freqs = rng.integers(0, 50, (6, n)).astype(np.uint32)
    freqs[1] = 0
    freqs[2, :] = 7                  # ties everywhere
    freqs[3, ::3] = 0
    freqs[4] = (rng.pareto(0.7, n) * 100).astype(np.uint32)  # deep trees
    np.testing.assert_array_equal(engine.length_tables(freqs, max_len),
                                  jh.exact_length_tables(freqs, max_len))
