from .pipeline import DataConfig, ShardedLoader, TokenSource
