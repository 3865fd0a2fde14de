"""The cloud-cluster simulator (copy of ``repro/sim``): trace replay of the
three-stage resource controller against the baseline schedulers."""
