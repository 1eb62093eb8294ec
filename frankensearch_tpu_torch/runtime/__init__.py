"""Product runtime (PyTorch port): layered config, agent ergonomics,
filesystem watching, the high-cost and privacy preflight contracts,
indexing orchestration, query expansion, the publication lease and the
query planner.

Parity target: crates/frankensearch-fsfs runtime internals (watcher.rs,
orchestration.rs, lifecycle.rs).
"""
