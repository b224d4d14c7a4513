"""Multi-channel imaging step (the W-slice loop around the kernels)."""
