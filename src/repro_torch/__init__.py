"""repro_torch: the RISC-V vector-engine simulator and RiVec suite in PyTorch.

A port of the JAX package ``repro`` to PyTorch and CUDA for one NVIDIA H100.
It imports neither JAX nor ``repro``; the tests hold it against ``repro``.

Layout mirrors the reference: ``core`` (trace IR, timing engine, memory
model, RiVec bodies, scalar baseline, suite), ``kernels`` (hand-written
CUDA kernels with their plain PyTorch versions), ``configs`` (the Table-10
grids).  Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (or CPU tensors), which selects the plain PyTorch path.
"""
