"""Run-shape presets of the scenario matrix (``sweeps``)."""
