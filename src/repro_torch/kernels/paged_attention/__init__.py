"""Paged decode attention: plain version, CUDA kernel, device dispatch."""
