"""Hand-written CUDA kernels for Hopper and their bindings.

One module per kernel (``crc16``, ``acl_match``, ``payload_store``,
``payload_fetch``, ``maglev``, ``paged_attention``, Split's and Merge's
control kernels ``split_control`` and ``merge_stage``, Merge's packet
transformation ``merge_payload``, and ``nf_chain``, the NF chain's header
pass): each holds the ``ctypes`` launch wrapper, its launch counter and an
import of its plain PyTorch version.  On the
dataplane paths ``crc16`` and ``payload_fetch`` run inside the control
kernels, and ``acl_match`` and ``maglev`` inside ``nf_chain`` (their device
code is shared through ``csrc/*.cuh``); the standalone kernels stay the
registry's ``crc16_tag``, ``payload_fetch``, ``acl_match`` and
``maglev_select`` primitives.  ``build`` compiles
``repro_torch/csrc/*.cu`` with ``nvcc`` at first use.  Nothing here touches
the card or the compiler when imported.
"""
from repro_torch.kernels import (acl_match, crc16, maglev, merge_payload,
                                 merge_stage, nf_chain, paged_attention,
                                 payload_fetch, payload_store, split_control)
from repro_torch.kernels.build import launch_counts, reset_launch_counts

KERNELS = ("crc16", "payload_store", "payload_fetch", "acl_match", "maglev",
           "paged_attention", "split_control", "merge_stage", "nf_chain",
           "merge_payload")

__all__ = ["KERNELS", "acl_match", "crc16", "launch_counts", "maglev",
           "merge_payload", "merge_stage", "nf_chain", "paged_attention",
           "payload_fetch", "payload_store", "reset_launch_counts",
           "split_control"]
