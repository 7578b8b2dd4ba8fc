"""Multi-process execution (port of gpd_tpu/parallel/).

gpd_tpu's mesh is single-process SPMD: ``shard_map`` runs over the local
devices of one process. PyTorch's idiom is one process per device, joined
by ``torch.distributed`` (NCCL between cards, gloo between CPU processes),
so the port's mesh is that process group (``sharded.Mesh``):

  - detection: every rank holds the replicated cloud and evaluates its
    contiguous shard of the sample axis; the survivors are gathered in rank
    order, so every rank holds the same merged batch, in gpd_tpu's
    ``out_specs=P(axis)`` layout (``parallel.sharded``);
  - CEM: each round's candidates are gathered the same way before the
    mixture refit (``cem.SequentialImportanceSampling(mesh=)``);
  - training: ``DistributedDataParallel`` over the group, each rank taking
    its slice of the same permuted batch (``net.train.fit``);
  - data generation: (object, view) work items round-robin over processes
    (``multihost.shard_work``, ``datagen.DataGenerator.generate``), each
    process writing its own HDF5 shard.

Every process calls the same functions in the same order (SPMD); a lost
process aborts the collective it was due in, as in gpd_tpu.
"""
