"""Build, load and launch-check the port's CUDA kernels.

The kernels under ``repro_torch/csrc/*.cu`` have a plain C interface and
are compiled by ``nvcc`` for ``sm_90a`` (one process per source, all
started together), linked into one shared library and loaded with
``ctypes``.  The build runs at first use into ``repro_torch/_build/``,
keyed by a hash of the sources and flags, so an unchanged tree reuses it.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.  Kernels run on PyTorch's current
stream, allocate nothing and do not synchronise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch import trace

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("crc16.cu", "acl_match.cu", "payload_store.cu",
           "payload_fetch.cu", "maglev.cu", "paged_attention.cu",
           "split_control.cu", "merge_stage.cu", "nf_chain.cu",
           "merge_payload.cu")
HEADERS = ("crc16.cuh", "meta_tables.cuh", "payload_fetch.cuh",
           "acl_match.cuh", "maglev.cuh")  # included by the sources
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _i64, _i32, _f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)
SIGNATURES = {
    "pp_crc16_tag": (_vp, _vp, _vp, _i64, _vp),
    "pp_acl_match": (_vp, _vp, _vp, _i64, _i32, _vp),
    "pp_payload_store": (_vp, _vp, _vp, _vp, _i64, _i64, _i64, _i64, _i64,
                         _vp),
    "pp_payload_fetch": (_vp, _vp, _vp, _vp, _i64, _i64, _i64, _i64, _vp),
    "pp_maglev_select": (_vp, _vp, _vp, _vp, _vp, _vp, _i64, _i32, _vp, _vp,
                         _i64, _i64, _vp),
    "pp_paged_attention": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                           _i32, _i64, _i32, _i32, _i32, _i32, _i32, _i32,
                           _i32, _i32, _i32, _f32, _vp),
    "pp_split_control": (_vp,) * 20 + (_i64, _i64, _i64, _i64, _i32, _i32,
                                       _i32, _i64, _i64, _vp, _vp),
    "pp_merge_stage": (_vp,) * 21 + (_i64, _i64, _i64, _i64, _i32, _i64,
                                     _i64, _vp, _vp),
    "pp_nf_chain": (_vp,) * 19 + (_i32, _i64, _i64, _i64, _vp),
    "pp_merge_payload": (_vp,) * 25 + (_i64,) * 5 + (_vp,),
}


LAUNCHES = "launches."   # prefix of the kernels' launch counters


def launch_counter(name: str) -> str:
    """The recorder's counter of ``name``'s launches (listed from now on by
    ``launch_counts``); its wrapper adds one per launch."""
    key = LAUNCHES + name
    trace.COUNTERS.setdefault(key, 0)
    return key


def launch_counts() -> dict[str, int]:
    return {k[len(LAUNCHES):]: v for k, v in sorted(trace.COUNTERS.items())
            if k.startswith(LAUNCHES)}


def reset_launch_counts() -> None:
    for k in trace.COUNTERS:
        if k.startswith(LAUNCHES):
            trace.COUNTERS[k] = 0


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set CUDA_HOME or PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels into one shared library (cached by content) and
    return its path.  The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept in ``build.log`` beside it."""
    lib = BUILD_DIR / f"libpp_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src} (rc {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib.name
        subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                        *map(str, objs)], check=True, capture_output=True)
        os.replace(tmp_lib, lib)
    return lib


_LIB: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The tensors' common CUDA device; raises for CPU tensors (the kernel
    path never falls back to the plain version)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise RuntimeError(
                f"{name}: the CUDA kernel needs all tensors on one CUDA "
                f"device, got {[str(x.device) for x in tensors]}; use "
                "backend='ref' or 'auto' for CPU tensors")
    return dev


def require_aligned(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: row tensors must be contiguous and 16-byte "
                f"aligned (shape {tuple(t.shape)}, ptr {t.data_ptr():#x})")


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
