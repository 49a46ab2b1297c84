"""Mamba-2 SSD scan: plain version, CUDA kernel, device dispatch."""
