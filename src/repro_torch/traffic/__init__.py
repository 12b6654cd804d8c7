"""Traffic generation (paper §6.1 workloads, the adversarial and churn
workloads of DESIGN.md §10), chunked trace sources for the streaming
driver, and multi-pipe steering."""
from repro_torch.traffic.generator import (ATTACK_SIZE, VICTIM_IP,
                                           VICTIM_PORT, AdversarialWorkload,
                                           ChurnWorkload, adversarial, churn)
from repro_torch.traffic.stream import (DiurnalLoad, FlowPool,
                                        MaterializedSource, SyntheticSource,
                                        TraceSource, as_source, splitmix32)

__all__ = [
    "ATTACK_SIZE", "VICTIM_IP", "VICTIM_PORT", "AdversarialWorkload",
    "ChurnWorkload", "adversarial", "churn", "DiurnalLoad", "FlowPool",
    "MaterializedSource", "SyntheticSource", "TraceSource", "as_source",
    "splitmix32",
]
