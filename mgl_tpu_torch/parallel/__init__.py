"""The port's parallel layer: the mesh of ranks, the sharded sort and
pipeline step, the elastic scale-out and its launcher, on
``torch.distributed``."""
