"""The benchmark of eov_tpu_torch: one cell of BENCHMARK.json, run once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that measures lives here and is read by name from
``BENCHMARK.json``: a configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json`` (the job it drives and its parameters), a job
``jobs/<job>.py``, a per-layer metric ``metrics/<name>.py``. The plain
reference that decides ``correct`` is ``reference/``; ``frozen/`` holds the
copies of the program's arithmetic that the yardstick must not lose when the
program changes. Nothing here imports JAX or the JAX package.
"""
