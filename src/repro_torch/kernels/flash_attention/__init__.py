"""Flash attention: plain version, CUDA kernel, device dispatch."""
