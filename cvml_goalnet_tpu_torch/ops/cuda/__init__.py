"""Hand-written CUDA kernels (``csrc/*.cu``) with their wrappers, plain versions and launch counts."""
