"""Local kernels: SpMV (with the CUDA DIA kernel) and local solves."""
