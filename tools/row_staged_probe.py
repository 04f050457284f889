"""Time the Row kernel's staged layout at other geometries than the one
``cuda_src.staged_geometry`` picks (on the card only).

Each case builds the fused loss's forward and backward (``launch.train._lse``)
at one (rows, V) in the staged layout with a cluster of K CTAs of T
threads, S row stages and CH chunks a slice, checks each against its plain
version under chip_smoke's kernel limit, and times it with CUDA events
queued behind a spin kernel.  Each (rows, V) runs in a process of its own:
the kernels' times in one process after a larger tensor was freed are not
comparable with those in a fresh one.

    python tools/row_staged_probe.py            # the cases below
    python tools/row_staged_probe.py 2048:32000  # one shape's cases

Prints one line a kernel: the geometry, its shared memory a CTA, the CTAs
an SM holds by shared memory, the time, the bound and their ratio.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: (rows, V) -> geometries (K, T, S, CH): the one row_source picks first
#: (a ring of S > 1 stages is filled by one copy a stage: CH = 1)
CASES = {
    (2048, 32000): [(1, 512, 1, 8), (2, 512, 2, 1), (2, 512, 1, 8),
                    (4, 256, 2, 1)],
    (2048, 256000): [(16, 256, 1, 8), (16, 256, 2, 1), (8, 512, 1, 8),
                     (9, 256, 1, 8), (10, 256, 1, 8)],
    (2048, 4096): [(1, 128, 4, 1), (1, 128, 1, 8)],
}


@contextlib.contextmanager
def geometry(T: int, S: int, CH: int):
    """cuda_src's staged geometry rules set to T threads and S stages (a
    ring filled by one copy a stage where S > 1, else one stage in CH
    chunks) for the builds made inside."""
    from repro_torch.kernels import cuda_src as c
    old = (c.staged_threads, c.STAGED_RING, c.STAGED_NARROW,
           c.STAGED_CHUNKS)
    c.staged_threads = lambda cols: T
    c.STAGED_RING, c.STAGED_CHUNKS = S, CH
    c.STAGED_NARROW = (1 << 40) if S > 1 else 0
    try:
        yield
    finally:
        (c.staged_threads, c.STAGED_RING, c.STAGED_NARROW,
         c.STAGED_CHUNKS) = old


def run_shape(rows: int, V: int) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, cuda_src, rowwise
    builds = []
    for label, cp in cs.loss_cplans(V, rows):
        for K, T, S, CH in CASES[(rows, V)]:
            with geometry(T, S, CH):
                src = cuda_src._staged_source(cp, cluster=K)
            builds.append((label, cp, (K, T, S, CH), src))
    build.build_all({b[3].key: b[3] for b in builds}.values())
    gen = torch.Generator(device="cuda").manual_seed(7)
    L = 2.0 * torch.randn((rows, V), generator=gen, device="cuda")
    g = torch.randn((rows, 1), generator=gen, device="cuda")
    orig = cuda_src.source_for
    for label, cp, geo, src in builds:
        env = {b.nid: (L if b.nid == cp.main.nid else g) for b in cp.binds}
        cuda_src.source_for = lambda c, bs=None: src if c is cp else \
            orig(c, bs)
        try:
            out = rowwise.row(cp, env)
            _err, share = cs.measure(cp, env, out, label)
            if not share <= 1.0:
                raise AssertionError(f"{label} {geo}: {share:.3g} x limit")
            ms = cs.queued_ms(lambda: rowwise.row(cp, env), reps=20)
        finally:
            cuda_src.source_for = orig
        bound, _by = cs.bound_ms(cp, env, out)
        print(f"[probe] {label:8s} {rows} x {V} K {geo[0]:2d} T {geo[1]:3d} "
              f"S {src.stages} CH {src.text.split('CH = ')[1].split(',')[0]}"
              f" smem {src.smem} ({src.ctas} a SM): "
              f"{'not measured' if ms is None else f'{ms:.4f} ms'}, bound "
              f"{bound:.4f} ms"
              + ("" if ms is None else f" ({bound / ms:.3f})"), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("row_staged_probe: needs the card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--shape"]:
        rows, V = (int(x) for x in args[1].split(":"))
        run_shape(rows, V)
        return 0
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    shapes = ([tuple(int(x) for x in a.split(":")) for a in args]
              or list(CASES))
    rc = 0
    for rows, V in shapes:
        rc |= subprocess.run([sys.executable, __file__, "--shape",
                              f"{rows}:{V}"]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
