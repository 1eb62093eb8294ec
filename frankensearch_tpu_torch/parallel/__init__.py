"""Multi-device scale-out (PyTorch): a mesh of shards, the sharded vector
scan with its exact top-k merge, the mesh-sharded fast tier, the
block-sharded BM25 arm, and training: the sharded contrastive step
(``train``), its checkpoints (``checkpoint``) and the GPipe pipeline
(``pipeline``).

Port of frankensearch_tpu/parallel/. The reference is single-controller:
one process holds a ``jax.sharding.Mesh``, ``shard_map`` runs the local
body on each device and ``all_gather`` merges the per-shard heaps; its
training step is one ``jax.jit`` over the mesh. The port keeps that shape
in one process: a :class:`~.mesh.Mesh` is a tuple of ``torch.device``s, one
per shard (several shards may share a card); each shard's tensors live on
its device, the local body launches the port's kernels there, and the
per-shard (B, k) heaps are copied to the lead device and merged exactly. A
training step is one autograd graph over the mesh's devices.
"""
