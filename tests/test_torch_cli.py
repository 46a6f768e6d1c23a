"""The port's command line (``python -m libzling_tpu_torch``) against the
JAX package's (``python -m libzling_tpu``, its default streaming backend),
run in subprocesses on a ~20 KB file with ``--backend cpu`` (every
kernel's plain version): the streams, the decoded bytes and the
``--checksum`` lines; stdin/stdout; the error exits (bad commands, corrupt
input, no GPU for ``--backend cuda``); ``--backend native``; ``--backend
pipeline`` against the JAX CLI's ``--backend pipeline``; the environment
override.

Tolerance: exact equality -- streams and outputs are bytes.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(pkg: str, *args, stdin: bytes | None = None, env=None):
    return subprocess.run([sys.executable, "-m", pkg, *map(str, args)],
                          input=stdin, capture_output=True, cwd=REPO,
                          timeout=300, env=env)


def _port(*args, **kw):
    return _run("libzling_tpu_torch", *args, **kw)


def _lines(stderr: bytes, prefix: bytes) -> list[bytes]:
    return [ln for ln in stderr.replace(b"\r", b"\n").splitlines()
            if ln.startswith(prefix)]


def _progress(stderr: bytes) -> list[bytes]:
    """The per-block progress lines and the summary without its time."""
    return [ln.split(b", time=")[0]
            for ln in stderr.replace(b"\r", b"\n").splitlines()
            if b" => " in ln]


@pytest.fixture(scope="module")
def blob(tmp_path_factory) -> pathlib.Path:
    # words with random bytes in the middle: the level drop fires
    rng = np.random.default_rng(11)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"\n"]
    text = b" ".join(words[i] for i in rng.integers(0, 5, 3500))
    path = tmp_path_factory.mktemp("cli") / "x.bin"
    path.write_bytes(text[:9000] + bytes(rng.integers(0, 256, 3000,
                                                      np.uint8))
                     + text[9000:])
    return path


@pytest.mark.parametrize("cmd", ["e0", "e4"])
def test_cli_equals_the_jax_cli(blob, tmp_path, cmd):
    mine, theirs, back = tmp_path / "m", tmp_path / "t", tmp_path / "b"
    r = _port(cmd, blob, mine, "--backend", "cpu", "--checksum")
    assert r.returncode == 0, r.stderr
    j = _run("libzling_tpu", cmd, blob, theirs, "--checksum")
    assert j.returncode == 0, j.stderr
    assert mine.read_bytes() == theirs.read_bytes()
    assert _lines(r.stderr, b"adler32:") == _lines(j.stderr, b"adler32:")
    assert _progress(r.stderr) == _progress(j.stderr)
    assert b"speed=" in r.stderr and b"MB/sec" in r.stderr

    r = _port("d", mine, back, "--backend", "cpu", "--checksum")
    j = _run("libzling_tpu", "d", theirs, tmp_path / "jb", "--checksum")
    assert r.returncode == 0 and j.returncode == 0, (r.stderr, j.stderr)
    assert back.read_bytes() == blob.read_bytes()
    assert _lines(r.stderr, b"adler32:") == _lines(j.stderr, b"adler32:")
    assert _progress(r.stderr) == _progress(j.stderr)


def test_cli_pipeline_equals_the_jax_cli_pipeline(blob, tmp_path):
    mine, theirs, back = tmp_path / "m", tmp_path / "t", tmp_path / "b"
    r = _port("e3", blob, mine, "--backend", "pipeline", "--checksum")
    j = _run("libzling_tpu", "e3", blob, theirs, "--backend", "pipeline",
             "--checksum")
    assert r.returncode == 0 and j.returncode == 0, (r.stderr, j.stderr)
    assert mine.read_bytes() == theirs.read_bytes()
    assert _lines(r.stderr, b"adler32:") == _lines(j.stderr, b"adler32:")
    assert _progress(r.stderr) == _progress(j.stderr)
    r = _port("d", mine, back, "--backend", "pipeline", "--checksum")
    assert r.returncode == 0, r.stderr
    assert back.read_bytes() == blob.read_bytes()
    assert _lines(r.stderr, b"adler32:") == _lines(j.stderr, b"adler32:")


def test_cli_stdin_stdout(blob):
    data = blob.read_bytes()
    r = _port("e4", "--backend", "cpu", stdin=data)
    assert r.returncode == 0, r.stderr
    assert r.stdout == _run("libzling_tpu", "e4", stdin=data).stdout
    d = _port("d", "--backend", "cpu", stdin=r.stdout)
    assert d.returncode == 0 and d.stdout == data


def test_cli_native_backend_and_override(blob, tmp_path):
    data = blob.read_bytes()
    r = _port("e2", "--backend", "native", "--checksum", stdin=data)
    assert r.returncode == 0, r.stderr
    env = dict(os.environ, LIBZLING_TPU_TORCH_BACKEND="cpu")
    d = _port("d", "--checksum", stdin=r.stdout, env=env)
    assert d.returncode == 0 and d.stdout == data
    assert _lines(r.stderr, b"adler32:") == _lines(d.stderr, b"adler32:")


def test_cli_bad_command_keeps_the_target(blob, tmp_path):
    target = tmp_path / "keep"
    target.write_bytes(b"precious")
    for args in (("frobnicate", blob, target), ("e9", blob, target),
                 ("e0", blob, target, "--backend", "tpu"),
                 ("e0", blob, target, "--backend")):
        r = _port(*args)
        assert r.returncode == 1, args
        assert target.read_bytes() == b"precious"
    r = _port("-h")
    assert r.returncode == 0 and b"usage:" in r.stderr
    assert _port().returncode == 1


def _corrupt(blob) -> dict:
    stream = _run("libzling_tpu", "e0", stdin=blob.read_bytes()).stdout
    return {"truncated": stream[:-5], "flag byte": b"\x02" + stream[1:]}


@pytest.mark.parametrize("name", ["truncated", "flag byte"])
def test_cli_corrupt_input(blob, name):
    bad = _corrupt(blob)[name]
    r = _port("d", "--backend", "cpu", stdin=bad)
    j = _run("libzling_tpu", "d", stdin=bad)
    assert r.returncode == j.returncode == 1
    assert b"Traceback" not in r.stderr
    assert _lines(r.stderr, b"error:") == _lines(j.stderr, b"error:")
    assert len(_lines(r.stderr, b"error:")) == 1


def test_cli_cuda_without_a_gpu_is_an_error(blob, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda backend runs")
    target = tmp_path / "keep"
    target.write_bytes(b"precious")
    env = {k: v for k, v in os.environ.items()
           if k != "LIBZLING_TPU_TORCH_BACKEND"}
    for args in (("e0", blob, target), ("e0", blob, target, "--backend",
                                        "cuda")):
        r = _port(*args, env=env)
        assert r.returncode != 0 and b"error:" in r.stderr
        assert b"no CUDA device" in r.stderr
        assert target.read_bytes() == b"precious"
