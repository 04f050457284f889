"""Shared hardware model — the costing substrate.

Single source of truth for the accelerator roofline constants and the
bandwidth-normalized time/volume terms used by *both* cost models in this
repo:

* the fusion planner's analytical operator costs (``core/cost.py``,
  paper §4.3 Eq. 4 — read/write/compute bandwidths), and
* the distributed layer: the layout planner (``dist/planner.py``) and the
  dry-run roofline analysis (``launch/roofline.py``).

Everything is expressed per chip: FLOP/s, HBM B/s, ICI B/s per link, and
HBM capacity for memory-feasibility pruning.

``TPU_V5E`` holds the reference package's TPU constants: the planner keeps
them as its default so the port selects exactly the reference's plans.
They are not figures for the GPU.  ``H100_SXM`` holds the NVIDIA H100 SXM
datasheet figures; moving the planner onto measured H100 constants is a
later, measured change (ROADMAP.md).  Collective volume helpers
follow the standard ring formulations (per-device bytes moved over ICI),
so ``collective_time(all_reduce_bytes(size, n))`` is the modeled ring
all-reduce latency at full link utilization.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12       # bf16 MXU FLOP/s
    hbm_bw: float = 819e9            # HBM B/s
    ici_bw: float = 50e9             # ICI B/s per link
    dcn_bw: float = 6.25e9           # cross-pod (DCN) B/s per chip
    hbm_bytes: float = 16e9          # HBM capacity per chip
    #: fraction of HBM usable for program state (rest: XLA scratch,
    #: fragmentation) — the layout planner's feasibility threshold.
    hbm_usable: float = 0.9


#: the reference's TPU v5e constants (planning default, see module doc)
TPU_V5E = HardwareSpec()

#: NVIDIA H100 SXM datasheet figures: 3.35 TB/s HBM3, 989 TFLOP/s dense
#: bf16 tensor-core rate, 80 GB, 450 GB/s NVLink each way per card (in the
#: ``ici_bw`` slot), and between nodes the DGX H100 datasheet's one
#: 400 Gb/s ConnectX-7 port per card, 50 GB/s (in the ``dcn_bw`` slot).
#: Datasheet values, not measured; the dry-run's roofline reads them, the
#: fusion planner does not.
H100_SXM = HardwareSpec(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                        ici_bw=450e9, dcn_bw=50e9, hbm_bytes=80e9)


# ---------------------------------------------------------------------------
# roofline time terms (seconds, per chip)
# ---------------------------------------------------------------------------

def compute_time(flops: float, hw: HardwareSpec = TPU_V5E) -> float:
    return flops / hw.peak_flops


def memory_time(nbytes: float, hw: HardwareSpec = TPU_V5E) -> float:
    return nbytes / hw.hbm_bw


def collective_time(nbytes: float, hw: HardwareSpec = TPU_V5E, *,
                    dcn: bool = False) -> float:
    return nbytes / (hw.dcn_bw if dcn else hw.ici_bw)


def step_time(compute_s: float, memory_s: float, collective_s: float) -> float:
    """Modeled step latency: compute overlaps HBM traffic (the MXU pulls
    operands while it works), but ICI collectives on the critical path
    overlap poorly at large TP spans — they serialize after the overlapped
    pair.  This is deliberately pessimistic about communication so layout
    search does not hide collective volume behind compute."""
    return max(compute_s, memory_s) + collective_s


# ---------------------------------------------------------------------------
# ring-collective per-device volumes (bytes moved over the interconnect)
# ---------------------------------------------------------------------------

def all_reduce_bytes(size: float, n: int) -> float:
    """Ring all-reduce of a ``size``-byte tensor over ``n`` devices:
    reduce-scatter + all-gather, each (n-1)/n · size per device."""
    return 0.0 if n <= 1 else 2.0 * (n - 1) / n * size


def all_gather_bytes(size: float, n: int) -> float:
    """Ring all-gather assembling a ``size``-byte full tensor on each
    device from 1/n shards."""
    return 0.0 if n <= 1 else (n - 1) / n * size


def reduce_scatter_bytes(size: float, n: int) -> float:
    return 0.0 if n <= 1 else (n - 1) / n * size


def all_to_all_bytes(size: float, n: int) -> float:
    """All-to-all re-bucketing of a ``size``-byte per-device payload:
    (n-1)/n of it leaves the device."""
    return 0.0 if n <= 1 else (n - 1) / n * size
