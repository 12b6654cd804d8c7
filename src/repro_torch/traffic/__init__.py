"""Traffic generation (paper §6.1 workloads) and multi-pipe steering."""
