"""fabric_egress.roofline_pct.churn: fabric_egress.roofline_pct in fabric255-churn, whose end-to-end metric is
egress_words_per_s.churn (the same reader, under its own name)."""
from scbench.harness import reader

read = reader("fabric_egress.roofline_pct")
