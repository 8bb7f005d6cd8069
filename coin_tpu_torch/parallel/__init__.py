"""Data parallelism over torch.distributed (counterpart of
coin_tpu/parallel/): the launcher, the process group and the reductions
that make a rank's share of a batch compute the global batch's step
(``mesh_utils``), and the host-side gathers and the store union
(``multihost``)."""
