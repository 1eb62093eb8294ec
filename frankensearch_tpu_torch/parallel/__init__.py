"""Document-axis scale-out (PyTorch): a mesh of shards, the sharded vector
scan with its exact top-k merge, the mesh-sharded fast tier and the
block-sharded BM25 arm.

Port of frankensearch_tpu/parallel/'s serving half. The reference is
single-controller: one process holds a ``jax.sharding.Mesh``, ``shard_map``
runs the local body on each device and ``all_gather`` merges the per-shard
heaps. The port keeps that shape in one process: a :class:`~.mesh.Mesh` is
a tuple of ``torch.device``s, one per shard (several shards may share a
card); each shard's tensors live on its device, the local body launches the
port's kernels there, and the per-shard (B, k) heaps are copied to the lead
device and merged exactly.
"""
