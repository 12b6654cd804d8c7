"""Production and host meshes (port of ``repro.launch.mesh``).

Functions, never module-level constants, so importing this module touches
no process group.  Each is a ``DeviceMesh`` over the current default
process group (``torch.distributed.init_process_group`` first, with a
world size equal to the mesh's device count: ``torchrun`` on cards with
``nccl``, or spawned processes with ``gloo`` on the CPU).
"""
from __future__ import annotations


def _mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16x16 = 256 devices, ("data", "model").
    Multi-pod: 2x16x16 = 512 devices, ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(model: int = 2, data: int = 2, pod: int = 1,
                   device_type: str = "cpu"):
    """Small mesh for distributed tests: ("data", "model"), with a leading
    "pod" axis when ``pod`` > 1."""
    if pod > 1:
        return _mesh(device_type, (pod, data, model),
                     ("pod", "data", "model"))
    return _mesh(device_type, (data, model), ("data", "model"))
