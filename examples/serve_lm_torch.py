"""Serve a small model with batched requests through the PyTorch port's
continuous-batching engine (prefill + decode with shared KV cache slots),
the counterpart of ``examples/serve_lm.py``: the reduced starcoder2-7b,
its weights drawn from a seeded ``torch.Generator``.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.serve import Engine, Request


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-new", type=int, default=12)
    args = ap.parse_args(argv)
    cfg = get_config("starcoder2-7b").reduced()
    gen = torch.Generator(device=args.device).manual_seed(0)
    model = LM(cfg, device=args.device).init(gen)
    engine = Engine(model, batch_slots=4, max_len=96)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=p).astype(np.int32),
                    max_new=args.max_new) for p in (9, 17, 5, 24, 13, 7)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt[{len(r.prompt)}] -> {r.out}")
    assert all(r.done and r.error is None and len(r.out) == args.max_new
               for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
    print("all requests served")
    return [r.out for r in reqs]


if __name__ == "__main__":
    main()
