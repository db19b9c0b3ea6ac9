"""Data: step-keyed token sources with prefetch (port of ``repro.data``)."""
from repro_torch.data.pipeline import (
    DataConfig,
    FileSource,
    PrefetchIterator,
    SyntheticSource,
    host_shard,
    make_source,
)

__all__ = [
    "DataConfig",
    "FileSource",
    "PrefetchIterator",
    "SyntheticSource",
    "host_shard",
    "make_source",
]
