"""The RG-LRU linear-recurrence scan: CUDA kernel, wrappers, plain version."""
