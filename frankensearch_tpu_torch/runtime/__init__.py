"""Product runtime (PyTorch port). Only the query planner is ported."""
