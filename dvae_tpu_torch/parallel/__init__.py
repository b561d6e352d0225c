"""Multi-device training and serving of the PyTorch port: one process per
device, joined by ``torch.distributed`` (``runtime``), and the mesh, the
sharding strategies and the per-step shards (``sharding``)."""
