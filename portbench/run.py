"""Run one cell of the port's benchmark on this machine's card:

    python3 portbench/run.py --workload pod_fw_nat.enterprise --seed 7 \
        --seconds 30 --trace 0

The last line of standard output is the result's JSON object; the checks
against the plain reference are the last lines of standard error.  Run it
from the root of a checkout: it puts the checkout's ``src`` (the port,
``repro_torch``) and the root (``portbench``) on the path.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
