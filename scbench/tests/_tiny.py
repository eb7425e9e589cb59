"""Tiny sizes at which the fabric cells run on the CPU (the port's plain
versions of its kernels) in a second or two."""
import time

import torch

from scbench import harness

FABRIC = {"config": {"hosts": 8, "tenants": 4, "sdm_pages": 8 * 256,
                     "span_pages": 64, "graph_scale": 8,
                     "table_capacity": 64},
          "params": {"words_per_row": 1024, "ring_steps": 2}}
CHURN_EVERY = 2


def overrides(cell: str) -> dict:
    out = {"config": dict(FABRIC["config"]),
           "params": dict(FABRIC["params"])}
    if "churn" in cell:
        out["params"]["commit_every"] = CHURN_EVERY
    return out


def run(cell: str, *, seed: int = 2**31 + 7, seconds: float = 0.3,
        trace: bool = False, **kw):
    """(record, line) of one tiny CPU run of ``cell`` (a window makes at
    least one commit of each kind, however slow the machine)."""
    return harness.run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(),
                            overrides=overrides(cell), log=lambda m: None,
                            **kw)
