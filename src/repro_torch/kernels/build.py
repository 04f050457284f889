"""Build, load and launch the generated CUDA kernels.

Each :class:`~repro_torch.kernels.cuda_src.KernelSource` compiles with
``nvcc`` for ``sm_90a`` into its own shared library with a plain
``extern "C"`` launcher (no PyTorch headers, so a build takes seconds),
loaded with :mod:`ctypes`.  Libraries go to ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of the generated text, the skeleton
headers and the flags, and are built at first use; :func:`build_all`
starts one ``nvcc`` per missing source at once, so a caller that knows its
kernels ahead (``chip_smoke.py``) builds them in parallel.  Nothing here
runs when the module is imported, and nothing falls back: a source that
does not build or a launch that is refused raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict[tuple, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA toolkit's compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found is None:
        from torch.utils.cpp_extension import CUDA_HOME
        cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
        found = cand if cand and os.path.exists(cand) else None
    if found is None:
        raise RuntimeError(
            "nvcc not found: the generated CUDA kernels are compiled with "
            "the CUDA toolkit's nvcc at first use")
    return found


@functools.lru_cache(maxsize=1)
def _headers_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def library_path(src: KernelSource) -> Path:
    h = hashlib.sha256()
    for part in (src.text, _headers_digest(), " ".join(NVCC_FLAGS)):
        h.update(part.encode())
    return BUILD_DIR / f"{src.template}_{h.hexdigest()[:20]}.so"


def build_all(sources: Iterable[KernelSource]) -> list[Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    each, all started together; returns the library paths.  Raises with
    the compiler's output when any build fails."""
    srcs = list(sources)
    paths = [library_path(s) for s in srcs]
    todo = {p: s for p, s in zip(paths, srcs) if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for path, src in todo.items():
        cu = path.with_suffix(".cu")
        cu.write_text(src.text)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        procs.append((path, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(cu)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for path, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, path)          # atomic: readers never see half
        else:
            failed.append((path, rc))
    if failed:
        path, rc = failed[0]
        raise RuntimeError(
            f"nvcc failed (rc={rc}) for {len(failed)} kernel(s); first: "
            f"{path.with_suffix('.cu')}\n"
            f"{path.with_suffix('.log').read_text()[-4000:]}")
    return paths


#: argument types of the two launcher ABIs: ``repro_launch`` (Cell, MAgg,
#: Row: bind pointers, out, part, m, nblocks, aux) and
#: ``repro_launch_outer`` (Outer: bind pointers, the BCSR's data, cols and
#: block-row pointer, its piece table, piece pointer and piece count, the
#: closer, out, part, m, n, nblocks, bs, r, k)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "repro_launch": [ctypes.POINTER(_P), _P, _P, _LL, _I, ctypes.c_double,
                     _P, _I],
    "repro_launch_outer": [ctypes.POINTER(_P), _P, _P, _P, _P, _P, _LL, _P,
                           _P, _P, _LL, _LL, _I, _I, _I, _I, _P, _I],
}


def launcher(src: KernelSource, symbol: str = "repro_launch"):
    """The loaded launcher ``symbol`` of this source, building it if
    needed."""
    with _LOCK:
        fn = _LOADED.get((src.key, symbol))
        if fn is None:
            (path,) = build_all([src])
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = _ARGTYPES[symbol]
            fn.restype = ctypes.c_int
            _LOADED[(src.key, symbol)] = fn
    return fn


# --------------------------------------------------------------------------
# shared wrapper steps
# --------------------------------------------------------------------------

def cuda_operands(cplan, env: dict) -> list[torch.Tensor]:
    """The bound tensors in bind order, checked: all on one CUDA device,
    fp32, contiguous, of the CPlan's shapes.  Raises on anything else."""
    main = env[cplan.main.nid]
    if not isinstance(main, torch.Tensor) or main.device.type != "cuda":
        raise ValueError(f"CUDA kernel needs CUDA tensors, got "
                         f"{getattr(main, 'device', type(main))}")
    out = []
    for b in cplan.binds:
        t = env[b.nid]
        if not isinstance(t, torch.Tensor) or t.device != main.device:
            raise ValueError(f"operand %{b.nid} is not a tensor on "
                             f"{main.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"operand %{b.nid}: {t.dtype}, kernels take "
                            f"float32")
        if tuple(t.shape) != tuple(b.shape):
            raise ValueError(f"operand %{b.nid}: shape {tuple(t.shape)} != "
                             f"planned {tuple(b.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"operand %{b.nid} is not contiguous")
        out.append(t)
    return out


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid(work: int, per_block: int, device: torch.device,
         blocks_per_sm: int) -> int:
    """CTAs for ``work`` items at ``per_block`` each, capped at a few waves
    of the card (the kernels loop over the rest)."""
    need = -(-max(int(work), 1) // per_block)
    return max(1, min(need, sm_count(device) * blocks_per_sm))


def launch(src: KernelSource, binds: list[torch.Tensor], out: torch.Tensor,
           part: Optional[torch.Tensor], m: int, nblocks: int,
           aux: float) -> None:
    """Launch on the current stream of the operands' device; raises when
    the launcher reports an error (a refused launch never runs)."""
    fn = launcher(src)
    dev = out.device
    ptrs = (ctypes.c_void_p * len(binds))(*[t.data_ptr() for t in binds])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ptrs, out.data_ptr(), part.data_ptr() if part is not None
            else None, int(m), int(nblocks), float(aux), stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"{src.template} kernel launch failed: "
                           f"cudaError {rc} ({library_path(src).name})")


def launch_outer(src: KernelSource, binds: list[torch.Tensor],
                 xdata: torch.Tensor, cols: torch.Tensor,
                 rowptr: torch.Tensor, pieces, closer: Optional[torch.Tensor],
                 out: torch.Tensor, part: torch.Tensor, m: int, n: int,
                 nblocks: int, bs: int, r: int, k: int) -> None:
    """Launch the Outer kernel (one CTA per piece of ``pieces``, a
    :class:`~repro_torch.kernels.blocksparse.Pieces`) and its fold on the
    current stream; raises when the launcher reports an error, including
    block size, rank or closer width other than the compiled ones."""
    for name, t in (("cols", cols), ("rowptr", rowptr),
                    ("piece table", pieces.table),
                    ("piece pointer", pieces.ptr)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != out.device:
            raise ValueError(f"BCSR {name}: contiguous int32 on "
                             f"{out.device} expected")
    fn = launcher(src, "repro_launch_outer")
    dev = out.device
    ptrs = (ctypes.c_void_p * len(binds))(*[t.data_ptr() for t in binds])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ptrs, xdata.data_ptr(), cols.data_ptr(), rowptr.data_ptr(),
            pieces.table.data_ptr(), pieces.ptr.data_ptr(),
            int(pieces.table.shape[0]),
            closer.data_ptr() if closer is not None else None,
            out.data_ptr(), part.data_ptr(), int(m), int(n), int(nblocks),
            int(bs), int(r), int(k), stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"outer kernel launch failed: cudaError {rc} "
                           f"({library_path(src).name})")
