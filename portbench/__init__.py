"""The port's benchmark: a data-driven harness over ``repro_torch``'s
dataplane engine (see PERF.md)."""
