"""Multi-device training and serving of the PyTorch port: one process per
device, joined by ``torch.distributed`` (``runtime``, with the collective
recorder), the mesh, the sharding strategies and the per-step shards
(``sharding``), and the collective census (``collective_cost``,
``census``)."""
