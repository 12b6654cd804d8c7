"""Switch + NF-server simulation: the multi-pipe engine, its host-loop
reference, faults, telemetry and results."""
