"""Analytical + clocked memory-system simulation for the reproduction.

Three layers: `lru` (exact reuse-distance / set-associative LRU models),
`model` (per-host analytical cycle cost of a workload trace, paper §7.1),
and `clock`/`replay` (the clocked fabric timing simulator: global-cycle
event loop, link contention, and trace replay).  Host-side numpy, as in
the JAX package; ``docs/timing_model.md`` shows how the pieces fit.
"""
from .clock import Clock, ClockedFabric, FabricTopology, Link, TimingConfig
from .lru import hit_curve, lru_hits, reuse_distances, set_assoc_hits
from .model import SimConfig, SimResult, binary_search_nodes, run_pair, simulate
from .replay import FabricTrace, ReplayReport, replay, timing_penalty
