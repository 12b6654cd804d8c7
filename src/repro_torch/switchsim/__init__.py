"""Switch + NF-server simulation: the multi-pipe engine, its host-loop
reference, the constant-memory streaming driver, faults, telemetry,
results and the analytic performance model."""
from repro_torch.switchsim.perfmodel import (HostOperatingPoint,
                                             OperatingPoint, ServerModel,
                                             TrafficDigest, digest, evaluate,
                                             evaluate_host, measured_digest,
                                             peak_goodput, scale_pipes)
from repro_torch.switchsim.results import StreamResult
from repro_torch.switchsim.stream import (SPLIT_MERGE_NS,
                                          StreamOracleMismatch, replay_oracle,
                                          run_stream, sojourn_ns, step_ns_for)

__all__ = [
    "HostOperatingPoint", "OperatingPoint", "ServerModel", "TrafficDigest",
    "digest", "evaluate", "evaluate_host", "measured_digest", "peak_goodput",
    "scale_pipes", "StreamResult", "SPLIT_MERGE_NS", "StreamOracleMismatch",
    "replay_oracle", "run_stream", "sojourn_ns", "step_ns_for",
]
