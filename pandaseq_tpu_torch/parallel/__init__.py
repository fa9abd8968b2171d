"""Multi-device paths of the PyTorch port: the (dp, op) mesh and its
sharded steps (``shard``), and the multi-process runner with its
torch.distributed counter reduction (``distributed``)."""
