"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one card.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of sits in a file of its own, found
by name (``registry``): configurations in ``configs/``, traffic mixes in
``traffic/`` (each names its driver in ``drivers/``), correctness limits
in ``limits/``, per-layer metrics in ``metrics/``, work counts in
``counts/``, the plain reference's layers in ``reference/``, its models in
``models/`` and the port's side of each model in ``adapters/``.
"""
