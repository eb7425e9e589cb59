"""scbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 scbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything a cell needs is found by name: its
parameters in ``workloads/<cell>.json``, its configuration in
``configs/<config>.json``, its traffic generator in ``traffic/``, its
driver in ``drivers/``, each per-layer metric's reader in
``metrics/<metric>.py``.  The work counts and peaks (``roofline/``) and the
plain reference (``reference/``) are frozen here, apart from the program.
"""
