"""Multi-view execution of the PyTorch port (counterpart of tpuao.parallel)."""
