"""The kernels: CUDA wrappers, their plain versions and dispatch."""
