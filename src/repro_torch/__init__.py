"""PyTorch / CUDA port of the ReckOn SoC reproduction.

A second package beside the JAX reference ``repro``: the same online
learning and serving paths (AER codec, bit-true quantized datapath,
e-prop with END_S / END_B commits, execution backend, batched and
streaming serving engine) on an NVIDIA H100, with the tick loops of the
Pallas TPU kernels rewritten as hand-written CUDA kernels
(``kernels/csrc``).  It imports ``torch`` and NumPy, never JAX or ``repro``.
Entry points run on ``device="cuda"`` unless the caller asks for ``"cpu"``,
where the kernels' plain PyTorch versions run.
"""
