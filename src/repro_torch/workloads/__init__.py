from . import gapbs, graphs
from .gapbs import KERNELS, TRACES, Trace
from .graphs import CSRGraph, make_graph
