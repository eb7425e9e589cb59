"""fabric.step_host_ms.churn: fabric.step_host_ms in fabric255-churn, whose end-to-end metric is
egress_words_per_s.churn (the same reader, under its own name)."""
from scbench.harness import reader

read = reader("fabric.step_host_ms")
