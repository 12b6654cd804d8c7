import os

# Smoke tests and benches must see ONE device (the dry-run sets its own flag
# as the very first line of launch/dryrun.py).  Keep threads bounded for the
# single-core CI container.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "float32")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")
