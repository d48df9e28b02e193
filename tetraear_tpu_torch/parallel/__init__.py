"""Pod-scale receive on torch.distributed: one rank per shard of a
(carrier, time) mesh (`mesh`), the overlap-save halo exchange and the
time-axis collectives (`halo`), world start-up (`distributed`) and the
sharded receive steps with their stitching receivers (`sharded`)."""
