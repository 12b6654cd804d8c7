"""Hand-written CUDA kernels for Hopper and their bindings.

One module per kernel (``crc16``, ``acl_match``, ``payload_store``,
``payload_fetch``, ``maglev``, ``paged_attention``): each holds the
``ctypes`` launch wrapper, its launch counter and an import of its plain
PyTorch version.  ``build`` compiles
``repro_torch/csrc/*.cu`` with ``nvcc`` at first use.  Nothing here touches
the card or the compiler when imported.
"""
from repro_torch.kernels import (acl_match, crc16, maglev, paged_attention,
                                 payload_fetch, payload_store)
from repro_torch.kernels.build import launch_counts, reset_launch_counts

KERNELS = ("crc16", "payload_store", "payload_fetch", "acl_match", "maglev",
           "paged_attention")

__all__ = ["KERNELS", "acl_match", "crc16", "launch_counts", "maglev",
           "paged_attention", "payload_fetch", "payload_store",
           "reset_launch_counts"]
