"""repro_torch — the PyTorch/CUDA port of ``repro``: cost-based
operator-fusion-plan optimization (Boehm et al., "On Optimizing Operator
Fusion Plans for Large-Scale Machine Learning in SystemML", PVLDB 2018)
running on an NVIDIA H100.

The planner (IR, OFMC exploration, MPSkipEnum selection, CPlans) is a copy
of the reference's framework-neutral modules; execution is torch, and the
Cell, MAgg and Row fused operators run as CUDA C++ kernels generated per
CPlan and compiled with ``nvcc`` at first use.  The LM serving path
(``configs``, ``models``, ``serve.Engine``) runs all ten architectures
(attention, MoE, Mamba and mLSTM layers), its rmsnorm through the
planner.  Importing this package
imports neither ``jax`` nor ``repro``.
"""

__version__ = "0.1.0"
