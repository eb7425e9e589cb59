"""device.idle_pct.churn: device.idle_pct.egress in fabric255-churn, whose
end-to-end metric is egress_words_per_s.churn (the same reader, under its
own name)."""
from scbench.harness import reader

read = reader("device.idle_pct.egress")
