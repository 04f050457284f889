"""Block-compressed sparse rows (BCSR) as torch tensors.

The reference keeps a sparse matrix as square (bs × bs) blocks, only the
non-zero ones, sorted row-major (``repro/kernels/blocksparse.py``); the
port keeps the same arrays, bit for bit, in torch tensors on any device.
Sparsity exploitation happens at block granularity: the Outer kernel
(``csrc/outer.cuh``) gives each CTA one *piece* of :attr:`BCSR.pieces`, a
run of at most :data:`PIECE_BLOCKS` consecutive blocks of one block row,
cut from :attr:`BCSR.rowptr`, the block-row pointer.

CLA compression keeps a matrix as per-column dictionaries
(:class:`DictCompressed`, the same arrays as the reference's, bit for bit).
The block-row partition for distributed segments is
:class:`ShardedBCSR` (:func:`partition_block_rows`, the reference's arrays
bit for bit); a rank of a mesh reads its own block rows of a whole BCSR
through :func:`block_row_panel`, a view.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import spans

DEFAULT_BLOCK = 128
#: most blocks in one piece of the Outer kernel's grid.  Xᵀ of the ALS
#: configuration has 139 block rows of ≈940 blocks on 132 SMs with two
#: CTAs each: one CTA per row left the last wave to a few SMs.  At 32 a
#: row of Xᵀ splits into ≈30 pieces (≈4,200 in all, ≈16 per CTA slot), so
#: the tail is a small share; a piece's fixed cost (its U rows, one (bs ×
#: k) partial written and folded) stays ≈2 % of its blocks' bytes.
PIECE_BLOCKS = 32


class Pieces(NamedTuple):
    """The Outer kernel's grid over a BCSR (see :attr:`BCSR.pieces`)."""
    #: (npieces, 3) int32: block row, first block, end block (exclusive)
    table: torch.Tensor
    #: (mb + 1,) int32: the pieces of block row i are ``ptr[i]:ptr[i + 1]``
    ptr: torch.Tensor


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


@dataclass
class BCSR:
    """Block-compressed sparse matrix.

    data:  (nb, bs, bs) non-zero blocks (dense inside, may contain zeros)
    rows:  (nb,) int32 block-row index of each block (row-major sorted)
    cols:  (nb,) int32 block-col index
    shape: logical (m, n); must be divisible by bs (pad first)
    """
    data: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    shape: tuple[int, int]
    bs: int = DEFAULT_BLOCK
    #: block-row pointer (mb + 1,) int32, computed once (see :attr:`rowptr`)
    _rowptr: Optional[torch.Tensor] = field(default=None, repr=False,
                                            compare=False)
    #: the piece table, computed once (see :attr:`pieces`)
    _pieces: Optional[Pieces] = field(default=None, repr=False,
                                      compare=False)

    def __post_init__(self) -> None:
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        self.bs = int(self.bs)

    # -- properties -----------------------------------------------------------
    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def block_sparsity(self) -> float:
        m, n = self.shape
        total = (m // self.bs) * (n // self.bs)
        return self.nblocks / max(total, 1)

    def nnz_fraction(self) -> float:
        return self.block_sparsity

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def rowptr(self) -> torch.Tensor:
        """(mb + 1,) int32: the blocks of block row i are
        ``rowptr[i]:rowptr[i + 1]`` (rows are sorted).  Computed on first
        use and kept on the object."""
        if self._rowptr is None:
            mb = self.shape[0] // self.bs
            bounds = torch.arange(mb + 1, dtype=torch.int32,
                                  device=self.rows.device)
            self._rowptr = torch.searchsorted(
                self.rows.contiguous(), bounds).to(torch.int32)
        return self._rowptr

    @property
    def pieces(self) -> Pieces:
        """Block row i of L blocks splits into P = max(1, ⌈L / C⌉) pieces
        of near-equal length (C = :data:`PIECE_BLOCKS`), in block order;
        piece q covers blocks ``rowptr[i] + ⌊qL/P⌋ : rowptr[i] +
        ⌊(q+1)L/P⌋``.  An empty row has one empty piece.  Computed from
        :attr:`rowptr` by torch ops on its device on first use and kept on
        the object."""
        if self._pieces is None:
            rp = self.rowptr.long()
            lens = rp[1:] - rp[:-1]
            per = torch.clamp((lens + PIECE_BLOCKS - 1) // PIECE_BLOCKS,
                              min=1)
            ptr = torch.cat([per.new_zeros(1), torch.cumsum(per, 0)])
            # the output's length is read from the device
            with spans.span("sync") if rp.is_cuda else spans.NOOP:
                row = torch.repeat_interleave(
                    torch.arange(lens.numel(), device=rp.device), per)
            q = torch.arange(row.numel(), device=rp.device) - ptr[row]
            first = rp[row] + q * lens[row] // per[row]
            end = rp[row] + (q + 1) * lens[row] // per[row]
            self._pieces = Pieces(
                torch.stack([row, first, end], 1).to(torch.int32)
                .contiguous(), ptr.to(torch.int32))
        return self._pieces

    def to(self, device) -> "BCSR":
        """This matrix on ``device`` (itself when it is already there)."""
        device = torch.device(device)
        if self.data.device == device:
            return self
        rp = self._rowptr.to(device) if self._rowptr is not None else None
        pc = Pieces(*(t.to(device) for t in self._pieces)) \
            if self._pieces is not None else None
        return BCSR(self.data.to(device), self.rows.to(device),
                    self.cols.to(device), self.shape, self.bs, rp, pc)

    # -- conversion -----------------------------------------------------------
    @staticmethod
    def from_dense(x, bs: int = DEFAULT_BLOCK) -> "BCSR":
        """The non-zero blocks of a dense (m, n) matrix (numpy array or
        tensor, on any device); keeps at least one block."""
        x = _tensor(x)
        m, n = x.shape
        if m % bs or n % bs:
            raise ValueError(f"pad {tuple(x.shape)} to a multiple of {bs} "
                             f"(pad_to_blocks)")
        mb, nbc = m // bs, n // bs
        blocks = x.reshape(mb, bs, nbc, bs).permute(0, 2, 1, 3)
        nz = blocks.abs().sum(dim=(2, 3)) > 0
        ridx, cidx = torch.nonzero(nz, as_tuple=True)   # row-major order
        data = blocks[ridx, cidx].contiguous()
        if ridx.numel() == 0:                           # keep one block
            ridx = torch.zeros(1, dtype=torch.long, device=x.device)
            cidx = torch.zeros(1, dtype=torch.long, device=x.device)
            data = torch.zeros((1, bs, bs), dtype=x.dtype, device=x.device)
        return BCSR(data, ridx.to(torch.int32), cidx.to(torch.int32),
                    (m, n), bs)

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        mb, nbc = m // self.bs, n // self.bs
        flat = torch.zeros((mb * nbc, self.bs, self.bs),
                           dtype=self.data.dtype, device=self.data.device)
        # the reference's scatter-add into zeros: a block position repeats
        # only with zero data (the padding of a ShardedBCSR's part)
        flat.index_add_(0, self.rows.long() * nbc + self.cols.long(),
                        self.data)
        return flat.reshape(mb, nbc, self.bs, self.bs) \
                   .permute(0, 2, 1, 3).reshape(m, n)

    @property
    def T(self) -> "BCSR":
        """Transposed copy, re-sorted row-major: a stable sort on the
        (col, row) key, as the reference's ``jnp.lexsort``."""
        mb = self.shape[0] // self.bs
        key = self.cols.long() * mb + self.rows.long()
        order = torch.argsort(key, stable=True)
        return BCSR(self.data[order].transpose(1, 2).contiguous(),
                    self.cols[order].contiguous(),
                    self.rows[order].contiguous(),
                    (self.shape[1], self.shape[0]), self.bs)


@dataclass
class ShardedBCSR:
    """Block-row-partitioned BCSR: the distributed form of :class:`BCSR`.

    :func:`partition_block_rows` splits a row-major BCSR into ``nparts``
    equal block-row ranges and pads every part to the same block count,
    so the stacked arrays have one shape.  Padding blocks carry zero data
    and point at the part's *last* real block row, which keeps each
    part's block list row-major sorted and makes the padded contributions
    exact zeros for every sparse path.

    data:   (nparts, nb_max, bs, bs) padded per-part blocks
    rows:   (nparts, nb_max) int32 *part-local* block-row indices
    cols:   (nparts, nb_max) int32 block-col indices
    shape:  global logical (m, n)
    """
    data: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    shape: tuple[int, int]
    bs: int = DEFAULT_BLOCK
    nparts: int = 1

    def __post_init__(self) -> None:
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        self.bs, self.nparts = int(self.bs), int(self.nparts)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "ShardedBCSR":
        device = torch.device(device)
        if self.data.device == device:
            return self
        return ShardedBCSR(self.data.to(device), self.rows.to(device),
                           self.cols.to(device), self.shape, self.bs,
                           self.nparts)

    def local_bcsr(self, part: int = 0) -> BCSR:
        """Part ``part`` as a BCSR over its (m/nparts, n) row panel, with
        part-local block-row indices."""
        m, n = self.shape
        return BCSR(self.data[part], self.rows[part], self.cols[part],
                    (m // self.nparts, n), self.bs)

    def unshard(self) -> BCSR:
        """The global BCSR; padding blocks survive as explicit zero
        blocks, neutral on every path."""
        m, n = self.shape
        per = (m // self.bs) // self.nparts
        offset = (torch.arange(self.nparts, dtype=self.rows.dtype,
                               device=self.rows.device) * per)[:, None]
        return BCSR(self.data.reshape(-1, self.bs, self.bs),
                    (self.rows + offset).reshape(-1),
                    self.cols.reshape(-1), (m, n), self.bs)

    def todense(self) -> torch.Tensor:
        return self.unshard().todense()


def partition_block_rows(x: BCSR, nparts: int) -> Optional[ShardedBCSR]:
    """Split ``x`` into ``nparts`` equal block-row ranges →
    :class:`ShardedBCSR` (on ``x``'s device), or None when the block-row
    count does not divide ``nparts`` (or ``nparts`` ≤ 1)."""
    m, n = x.shape
    mb = m // x.bs
    if nparts <= 1 or mb % nparts:
        return None
    rows = x.rows.cpu().numpy()
    cols = x.cols.cpu().numpy()
    per = mb // nparts
    shard_of = rows // per
    counts = np.bincount(shard_of, minlength=nparts)
    nb_max = max(int(counts.max()), 1)
    data = x.data
    pdata = torch.zeros((nparts, nb_max, x.bs, x.bs), dtype=data.dtype,
                        device=data.device)
    prows = np.zeros((nparts, nb_max), np.int32)
    pcols = np.zeros((nparts, nb_max), np.int32)
    for s in range(nparts):
        idx = np.nonzero(shard_of == s)[0]        # row-major order kept
        k = len(idx)
        if k:
            pdata[s, :k] = data[torch.as_tensor(idx, device=data.device)]
            prows[s, :k] = rows[idx] - s * per
            pcols[s, :k] = cols[idx]
            # padding points at the last real block row
            prows[s, k:] = prows[s, k - 1]
            pcols[s, k:] = pcols[s, k - 1]
    dev = x.rows.device
    return ShardedBCSR(pdata, torch.as_tensor(prows, device=dev),
                       torch.as_tensor(pcols, device=dev), (m, n), x.bs,
                       nparts)


def block_row_panel(x: BCSR, nparts: int, part: int) -> Optional[BCSR]:
    """Block rows ``part·mb/nparts : (part+1)·mb/nparts`` of ``x`` as a
    BCSR over its (m/nparts, n) row panel — the blocks of
    ``partition_block_rows(x, nparts).local_bcsr(part)`` without the
    padding: a view of ``x``'s blocks (rows are sorted, so a block-row
    range is one run of them), part-local row indices; a panel with no
    block keeps one zero block, as :meth:`BCSR.from_dense` does.  None
    when the block rows do not divide ``nparts``."""
    m, n = x.shape
    mb = m // x.bs
    if nparts < 1 or mb % nparts:
        return None
    per = mb // nparts
    rp = x.rowptr
    lo, hi = int(rp[part * per]), int(rp[(part + 1) * per])
    shape = (m // nparts, n)
    if hi == lo:
        zero = torch.zeros(1, dtype=torch.int32, device=x.rows.device)
        return BCSR(x.data.new_zeros((1, x.bs, x.bs)), zero, zero, shape,
                    x.bs)
    local_rp = (rp[part * per:(part + 1) * per + 1] - lo).contiguous()
    return BCSR(x.data[lo:hi], (x.rows[lo:hi] - part * per).contiguous(),
                x.cols[lo:hi], shape, x.bs, local_rp)


def pad_to_blocks(x, bs: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Zero-pad a dense matrix so both dims divide the block size."""
    x = _tensor(x)
    m, n = x.shape
    pm, pn = (-m) % bs, (-n) % bs
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    return x


# --------------------------------------------------------------------------
# CLA compression
# --------------------------------------------------------------------------

#: rows a chunk of :meth:`DictCompressed.todense` gathers at once (its
#: int64 gather index is 8 bytes a cell)
TODENSE_ROWS = 1 << 20


@dataclass
class DictCompressed:
    """CLA-style column-compressed matrix (paper ref [28]).

    values: (ncol, ndist) fp32 per-column dictionary (padded with 0),
            each column's distinct values in ascending order
    codes:  (nrow, ncol) int32 indices into the column dictionary
    counts: (ncol, ndist) fp32 occurrences of each distinct value
    """
    values: torch.Tensor
    codes: torch.Tensor
    counts: torch.Tensor
    shape: tuple[int, int]

    def __post_init__(self) -> None:
        self.shape = (int(self.shape[0]), int(self.shape[1]))

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "DictCompressed":
        """This matrix on ``device`` (itself when it is already there)."""
        device = torch.device(device)
        if self.values.device == device:
            return self
        return DictCompressed(self.values.to(device), self.codes.to(device),
                              self.counts.to(device), self.shape)

    @staticmethod
    def from_dense(x, max_distinct: int = 256) -> "DictCompressed":
        """Compress a dense (m, n) matrix (numpy array or tensor, on any
        device): one sorted ``torch.unique`` per column, on the matrix's
        device.  Raises ``ValueError`` on a column with more than
        ``max_distinct`` distinct values."""
        x = _tensor(x)
        m, n = x.shape
        vals_l, codes_l, counts_l = [], [], []
        for c in range(n):
            v, code, cnt = torch.unique(x[:, c], sorted=True,
                                        return_inverse=True,
                                        return_counts=True)
            if v.numel() > max_distinct:
                raise ValueError(f"column {c}: {v.numel()} distinct values")
            vals_l.append(v)
            codes_l.append(code.to(torch.int32))
            counts_l.append(cnt)
        ndist = max([1] + [v.numel() for v in vals_l])
        values = torch.zeros((n, ndist), dtype=x.dtype, device=x.device)
        counts = torch.zeros((n, ndist), dtype=x.dtype, device=x.device)
        for c in range(n):
            values[c, :vals_l[c].numel()] = vals_l[c]
            counts[c, :counts_l[c].numel()] = counts_l[c].to(x.dtype)
        codes = torch.stack(codes_l, dim=1) if codes_l else \
            torch.zeros((m, 0), dtype=torch.int32, device=x.device)
        return DictCompressed(values, codes.contiguous(), counts, (m, n))

    def todense(self) -> torch.Tensor:
        """The dense (m, n) matrix: ``values[c, codes[i, c]]``, gathered
        in chunks of :data:`TODENSE_ROWS` rows."""
        m, n = self.shape
        vt = self.values.T.contiguous()                   # (ndist, ncol)
        out = torch.empty((m, n), dtype=vt.dtype, device=vt.device)
        for r0 in range(0, m, TODENSE_ROWS):
            idx = self.codes[r0:r0 + TODENSE_ROWS].long()
            out[r0:r0 + TODENSE_ROWS] = torch.gather(vt, 0, idx)
        return out

    @property
    def compression_ratio(self) -> float:
        m, n = self.shape
        dense = m * n * 4
        comp = (self.values.numel() + self.counts.numel()) * 4 \
            + self.codes.numel()
        return dense / comp
