"""device.idle_pct.serve: device.idle_pct.egress in the serving cell (the
same reader, under its own name): the share of the traced window in which
no kernel, copy or set ran on the card."""
from scbench.harness import reader

read = reader("device.idle_pct.egress")
