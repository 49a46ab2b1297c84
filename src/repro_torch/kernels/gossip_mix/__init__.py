"""Gossip mix: plain version, CUDA kernel, device dispatch."""
