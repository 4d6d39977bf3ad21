"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The layout mirrors ``repro`` (``configs/``, ``models/``, ``kernels/``,
``launch/``, ``core/``) so each module's counterpart is found by name;
``csrc/`` holds the hand-written CUDA C++ kernels.  The package imports
torch, numpy and the standard library only: never jax, and never a module
of ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
