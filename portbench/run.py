"""The port's benchmark, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It measures ``repro_torch`` (``src/``) on the
CUDA card, exits with 2 and prints no result when there is none, and prints
the result as one JSON object on its last line of standard output.  Build
and kernel caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(CACHE / sub)


def _port_on_path() -> None:
    """Put this checkout's ``src`` first, and refuse a port found
    anywhere else."""
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        raise SystemExit(f"no repro_torch under {src}: run from a checkout "
                         f"that holds the port")
    sys.path[0:1] = [str(ROOT), str(src)]


if __name__ == "__main__":
    _port_on_path()
    from portbench import harness
    sys.exit(harness.main(t_start=T_START))
