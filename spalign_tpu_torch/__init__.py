"""spalign_tpu_torch: the PyTorch/CUDA port of spalign_tpu.

Runs the fused-SLIC road-label path on an NVIDIA Hopper GPU, with the
SLIC Lloyd loop as a hand-written CUDA kernel (``csrc/slic_lloyd.cu``).
Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run
the plain PyTorch versions on the CPU.  The package imports neither JAX
nor ``spalign_tpu``.
"""

__version__ = "0.1.0"
