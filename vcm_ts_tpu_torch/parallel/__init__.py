"""Multi-process training and serving on torch.distributed (the port's
counterpart of vcm_ts_tpu/parallel/): `mesh` for data parallelism, `tensor`
for fully sharded data parallelism and tensor parallelism, `spatial` for
one stream's frames split by rows."""
