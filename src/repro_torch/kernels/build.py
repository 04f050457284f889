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

from repro_torch import spans

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
    with spans.span("kernels.build"):
        return _build_all(list(sources))


def _build_all(srcs: list[KernelSource]) -> list[Path]:
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


#: argument types of the launcher ABIs: ``repro_launch`` (Cell, MAgg,
#: Row: bind pointers, per-request bind strides, request count, out, out's
#: per-request stride, part, tickets, m, nblocks per request, aux; see
#: ``cuda_src.LAUNCH_SIGNATURE``) and
#: ``repro_launch_outer`` (Outer: bind pointers, the BCSR's data, cols and
#: block-row pointer, its piece table, piece pointer and piece count, the
#: closer, out, part, m, n, nblocks, bs, r, k), and the attention kernel's
#: ``attn_fwd`` / ``attn_bwd`` (:mod:`repro_torch.kernels.attention`)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "repro_launch": [ctypes.POINTER(_P), ctypes.POINTER(_LL), _I, _P, _LL, _P,
                     _P, _LL, _I, ctypes.c_double, _P, _I],
    "repro_launch_outer": [ctypes.POINTER(_P), _P, _P, _P, _P, _P, _LL, _P,
                           _P, _P, _LL, _LL, _I, _I, _I, _I, _P, _I],
    # csrc/attn.cuh: q, k, v, kv_of, out, lse; B, S, H, KV, window, scale
    "attn_fwd": [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P, _I],
    # q, k, v, kv_of, dout, lse, delta, dq, dk, dv; B, S, H, KV, window,
    # scale
    "attn_bwd": [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P, _I],
}


def launcher(src: KernelSource, symbol: str = "repro_launch"):
    """The loaded launcher ``symbol`` of this source, building it if
    needed."""
    with _LOCK:
        fn = _LOADED.get((src.key, symbol))
        if fn is None:
            with spans.span("kernels.build"):
                (path,) = _build_all([src])
                fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = _ARGTYPES[symbol]
            fn.restype = ctypes.c_int
            _LOADED[(src.key, symbol)] = fn
    return fn


# --------------------------------------------------------------------------
# shared wrapper steps
# --------------------------------------------------------------------------

def _main_device(cplan, env: dict) -> torch.device:
    main = env[cplan.main.nid]
    if not isinstance(main, torch.Tensor) or main.device.type != "cuda":
        raise ValueError(f"CUDA kernel needs CUDA tensors, got "
                         f"{getattr(main, 'device', type(main))}")
    return main.device


def _on(b, t, device: torch.device) -> torch.Tensor:
    """Bound value ``t`` of bind ``b``, checked: a fp32 tensor on
    ``device``."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"operand %{b.nid} is not a tensor on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"operand %{b.nid}: {t.dtype}, kernels take "
                        f"float32")
    return t


def cuda_operands(cplan, env: dict) -> list[torch.Tensor]:
    """The bound tensors in bind order, checked: all on one CUDA device,
    fp32, contiguous, of the CPlan's shapes.  Raises on anything else."""
    dev = _main_device(cplan, env)
    out = []
    for b in cplan.binds:
        t = _on(b, env[b.nid], dev)
        if tuple(t.shape) != tuple(b.shape):
            raise ValueError(f"operand %{b.nid}: shape {tuple(t.shape)} != "
                             f"planned {tuple(b.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"operand %{b.nid} is not contiguous")
        out.append(t)
    return out


def cuda_batched_operands(cplan, env: dict
                          ) -> tuple[list[torch.Tensor], list[int], int]:
    """The bound tensors of a batched call in bind order, with each one's
    per-request stride (floats) and the request count B: a (B, *shape)
    tensor whose requests are each contiguous has stride ``stride(0)``, a
    2-D tensor of the bind's shape is shared by every request (stride 0).
    All on one CUDA device, fp32.  Raises on anything else."""
    dev = _main_device(cplan, env)
    out, strides, counts = [], [], set()
    for b in cplan.binds:
        t = _on(b, env[b.nid], dev)
        if t.dim() == 3:
            if tuple(t.shape[1:]) != tuple(b.shape) \
                    or not t[0].is_contiguous():
                raise ValueError(f"batched operand %{b.nid}: "
                                 f"{tuple(t.shape)} (strides {t.stride()}) "
                                 f"is not (B, {tuple(b.shape)}) with each "
                                 f"request contiguous")
            counts.add(int(t.shape[0]))
            strides.append(int(t.stride(0)) if t.shape[0] > 1 else 0)
        elif tuple(t.shape) == tuple(b.shape) and t.is_contiguous():
            strides.append(0)                  # shared by every request
        else:
            raise ValueError(f"operand %{b.nid}: shape {tuple(t.shape)} != "
                             f"planned {tuple(b.shape)}")
        out.append(t)
    if len(counts) != 1:
        raise ValueError(f"batched operands need one request count, got "
                         f"{sorted(counts)}")
    return out, strides, counts.pop()


def batch_stride(shape) -> int:
    """Floats between consecutive requests of a stacked (r, c) operand:
    r·c rounded up to a multiple of 4, so every request starts on a
    16-byte boundary (the Cell kernel's vector walk reads float4)."""
    r, c = shape
    return -(-(r * c) // 4) * 4


def batch_empty(nreq: int, shape, device) -> torch.Tensor:
    """An uninitialised (nreq, r, c) fp32 stack whose requests are each
    contiguous and :func:`batch_stride` floats apart."""
    r, c = shape
    stride = batch_stride((r, c))
    flat = torch.empty(nreq * stride, dtype=torch.float32, device=device)
    return flat.as_strided((nreq, r, c), (stride, c, 1))


def batch_aligned(t: torch.Tensor) -> bool:
    """Whether a (B, r, c) tensor is stacked as the request-axis kernels
    read it: each request contiguous, the first on a 16-byte boundary and
    the requests a multiple of 4 floats apart."""
    if t.dim() != 3 or not t[0].is_contiguous() or t.data_ptr() % 16:
        return False
    nreq, r, c = t.shape
    return nreq == 1 or (t.stride(0) % 4 == 0 and t.stride(0) >= r * c)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def share(ctas: int, nreq: int) -> int:
    """CTAs each of ``nreq`` requests gets of a persistent grid of
    ``ctas``: the grid is shared out over the requests (at least one)."""
    return max(1, -(-ctas // max(int(nreq), 1)))


def grid(work: int, per_block: int, device: torch.device,
         blocks_per_sm: int, nreq: int = 1) -> int:
    """CTAs per request for ``work`` items at ``per_block`` each, capped
    at a few waves of the card shared out over ``nreq`` requests (the
    kernels loop over the rest)."""
    need = -(-max(int(work), 1) // per_block)
    return max(1, min(need, share(sm_count(device) * blocks_per_sm, nreq)))


def launch(src: KernelSource, binds: list[torch.Tensor], out: torch.Tensor,
           part: Optional[torch.Tensor], m: int, nblocks: int,
           aux: float, strides: Optional[list[int]] = None, nreq: int = 1,
           ostride: int = 0, ticket: Optional[int] = None) -> None:
    """Launch on the current stream of the operands' device, ``nreq``
    requests in one launch (bind k of request q at its pointer plus
    ``q * strides[k]`` floats, its output at ``out`` plus ``q * ostride``;
    ``ticket``: the address of the Cell kernel's per-request tickets);
    raises when the launcher reports an error (a refused launch never
    runs)."""
    fn = launcher(src)
    dev = out.device
    ptrs = (ctypes.c_void_p * len(binds))(*[t.data_ptr() for t in binds])
    strd = (ctypes.c_longlong * max(len(binds), 1))(
        *(strides if strides is not None else [0] * len(binds)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ptrs, strd, int(nreq), out.data_ptr(), int(ostride),
            part.data_ptr() if part is not None else None, ticket, int(m),
            int(nblocks), float(aux), stream, dev.index)
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
