"""The paper's flagship workload end-to-end on the PyTorch port: ALS-CG
matrix factorization over block-sparse ratings, with the Gen-optimized
sparsity-exploiting Outer-template operators (on the card, the generated
Outer CUDA kernel), against the hand-written dense-mask baseline; the
counterpart of ``examples/als_recommender.py``.

Run:  PYTHONPATH=src python examples/als_recommender_torch.py [--device cpu]
"""

import argparse
import time

from repro_torch.algos import als_cg, data
from repro_torch.configs.als_paper import CONFIG


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--cols", type=int, default=1536)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args(argv)
    X = data.ratings(args.rows, args.cols, rank=CONFIG.rank,
                     bs=CONFIG.block_size, block_density=0.15, seed=0,
                     device=args.device)
    print(f"ratings: {X.shape}, {X.nblocks} non-zero blocks "
          f"(block density {X.block_sparsity:.2f})")
    losses = {}
    for mode in ("gen", "hand"):
        t0 = time.perf_counter()
        _U, _V, losses[mode] = als_cg.run(
            X, rank=CONFIG.rank, lam=CONFIG.lam, max_iter=args.iters,
            max_inner=CONFIG.max_inner, mode=mode, device=args.device)
        dt = time.perf_counter() - t0
        print(f"{mode:5s}: loss {losses[mode][0]:.1f} -> "
              f"{losses[mode][-1]:.1f} in {dt:.1f}s")
    assert losses["gen"][-1] < losses["gen"][0], losses["gen"]
    return losses


if __name__ == "__main__":
    main()
