"""Traffic generators: each reads a cell's parameters from its
``workloads/<cell>.json`` and makes the inputs from the run's seed."""
