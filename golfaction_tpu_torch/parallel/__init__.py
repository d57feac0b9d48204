"""Data parallelism on torch.distributed, one process a device: the mesh
(`mesh`), the neighbour exchange (`comm`) and the data-parallel train step
(`train_step`)."""
