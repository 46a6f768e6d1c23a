"""What the benchmark's processes load: never JAX or the JAX package, and
the reference nothing of the program either.

Each check runs in a fresh process and compares the top-level name of
every module it holds (the part before the first dot) whole:
``libzling_tpu_torch`` is the program, ``libzling_tpu`` the JAX package.
"""

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "libzling_tpu"}

TOPS = ("print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")


def top_level_modules(code: str) -> set[str]:
    r = subprocess.run([sys.executable, "-c",
                        f"import json, sys\n{code}\n{TOPS}"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a cell (on the CPU, small) as ``run.py`` drives it,
    the trace reader included."""
    tops = top_level_modules(
        "sys.path.insert(0, 'benchmark')\n"
        "import run\n"
        "from benchmark.harness import runner, reading\n"
        "out = runner.run('enwik8-e4.decode', 11, 0.2, False,\n"
        "                 system=lambda: runner.Port('cpu'),\n"
        "                 corpus_override={'bytes': 30000})\n"
        "assert out['result']['correct']\n"
        "assert run.forbidden_modules() == []")
    assert "libzling_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = top_level_modules(
        "from benchmark.harness import corpus\n"
        "from benchmark.reference import codec\n"
        "d = corpus.generate({'bytes': 50000}, 1)\n"
        "s = codec.encode(d, 4)\n"
        "assert codec.decode(s) == d and codec.token_counts(s)[0] > 0\n"
        "assert codec.decode_blocks_apart(codec.encode_blocks_apart(d, 0))"
        " == d")
    assert not tops & (FORBIDDEN | {"libzling_tpu_torch", "torch"}), tops


def test_forbidden_modules_compares_whole_names():
    top_level_modules(
        "sys.path.insert(0, 'benchmark')\n"
        "import run\n"
        "sys.modules['libzling_tpu_torch_x'] = sys\n"
        "sys.modules['jaxlibrary'] = sys\n"
        "assert run.forbidden_modules() == []\n"
        "sys.modules['libzling_tpu.spec'] = sys\n"
        "sys.modules['jax._src'] = sys\n"
        "assert run.forbidden_modules() == ['jax', 'libzling_tpu']")


def test_run_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "enwik8-e0.encode", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA" in r.stderr
