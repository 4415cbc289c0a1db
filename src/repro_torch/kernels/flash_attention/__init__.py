"""Ring-chunk attention: CUDA kernel, wrapper and plain version."""
