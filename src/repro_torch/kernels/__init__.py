"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``) with their plain torch versions and public wrappers (``ops``)."""
