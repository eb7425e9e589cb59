"""egress_words_per_s.churn: egress_words_per_s in fabric255-churn, whose
window also holds the lifecycle commits; a metric of its own so that the
churn cell's run-to-run spread sets its own bound."""
from scbench.harness import reader

read = reader("egress_words_per_s")
