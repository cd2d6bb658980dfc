"""pqbench: the benchmark of the PyTorch and CUDA port, ``pqvector_tpu_torch``.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line::

    python3 pqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name:
``configs/<name>.json`` (the deployment), ``traffic/<name>.json`` (which
names its driver, ``drivers/<driver>.py``), ``metrics/<name>.py`` (a reader of
the traced run's record) and ``limits/<cell>.json`` (the limits of the
numbers that decide ``correct``). ``reference/`` is the plain reference that
judges the program's answers; it imports nothing of the program.

Nothing here imports JAX or the JAX package ``pqvector_tpu``.
"""
