"""PyTorch + CUDA port of the PayloadPark dataplane (Split -> NF chain -> Merge).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``core``, ``backend``, ``nf``, ``switchsim``, ``traffic``) so each
counterpart is easy to find.  It imports ``torch`` and ``numpy`` only.

Hot-path primitives run as hand-written CUDA kernels for Hopper
(``csrc/*.cu``, bound through ``ctypes`` in ``kernels/``) on CUDA tensors
and as their plain PyTorch versions (``backend/ref.py``) on CPU tensors.
Entry points that create tensors take ``device`` (default ``"cuda"``) and
raise when no card is present rather than running on the CPU.
"""
