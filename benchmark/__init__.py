"""The benchmark of the PyTorch/CUDA port (``libzling_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the root ``BENCHMARK.json`` once and
prints one JSON line.  Everything that defines a cell is data found by
name: ``configs/<config>.json`` (the deployment: level, size, corpus),
``traffic/<traffic>.json`` (the operation and its loop),
``stages/<stage>/`` (a stage's work count and its kernels' names) and
``metrics/<metric>.py`` (a per-layer metric's reader).  ``harness/`` is
the general code, ``reference/`` the plain codec every output is held to,
``corpus/`` the frozen generator's sources.  Nothing here imports JAX or
the JAX package; only the harness's runner imports the port.
"""
