"""Data of the port: the sharded loader and synthetic experiment data."""
from repro_torch.data.pipeline import ShardedLoader, take  # noqa: F401
from repro_torch.data import synthetic  # noqa: F401
