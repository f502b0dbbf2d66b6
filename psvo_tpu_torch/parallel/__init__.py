"""Data and particle sharding over `torch.distributed` (counterpart of
`psvo_tpu/parallel/`): the active mesh (`context`), the collectives the
sharded paths call explicitly (`collectives`), the mesh, the sharded train
and eval steps and the dry run (`sharding`), and the launcher of rank
processes (`launch`)."""
