"""The paper's own flagship workload config (ALS-CG, rank 20) for the
end-to-end recommender example."""
from dataclasses import dataclass


@dataclass(frozen=True)
class ALSConfig:
    rank: int = 20
    lam: float = 1e-3
    max_iter: int = 10
    max_inner: int = 5
    block_size: int = 128


CONFIG = ALSConfig()
