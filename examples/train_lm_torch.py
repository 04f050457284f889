"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps with the fused loss, checkpointing and restart — the
counterpart of ``examples/train_lm.py``, through
``repro_torch.launch.train.main`` with the same defaults (minitron-4b,
the ``100m`` preset, 300 steps, batch 8 x 512, ``--fusion gen``).  Any
argument given overrides its default.

Run:  PYTHONPATH=src python examples/train_lm_torch.py
(CPU demo: --device cpu --preset tiny --steps 6 --batch 2 --seq 64)
"""

import sys

from repro_torch.launch.train import main

DEFAULTS = ["--arch", "minitron-4b", "--preset", "100m", "--steps", "300",
            "--batch", "8", "--seq", "512", "--fusion", "gen"]

if __name__ == "__main__":
    main(DEFAULTS + sys.argv[1:])
