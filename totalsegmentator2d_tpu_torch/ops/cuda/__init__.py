"""Hand-written CUDA kernels for Hopper (sm_90a), their build step and their
plain PyTorch versions."""
