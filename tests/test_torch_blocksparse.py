"""The port's BCSR (``repro_torch.kernels.blocksparse``) against the JAX
reference's: ``from_dense``, ``todense``, ``.T``, ``pad_to_blocks``, the
block-row pointer, the carrier ``interop.to_bcsr`` and ``data.ratings``,
on seeded numpy inputs.  The index arrays and block data must be the
reference's exactly (bit for bit).  Also the Outer kernel's piece table
(``BCSR.pieces``), which has no reference counterpart: its invariants."""

import numpy as np
import pytest
import torch

from repro.algos import data as ref_data
from repro.kernels import blocksparse as rbs
from repro_torch.algos import data
from repro_torch.interop import to_bcsr, to_sharded_bcsr
from repro_torch.kernels.blocksparse import (BCSR, PIECE_BLOCKS,
                                            ShardedBCSR, block_row_panel,
                                            pad_to_blocks,
                                            partition_block_rows)

torch.set_num_threads(1)


def _dense(grid, bs, density, seed, empty_rows=()):
    rng = np.random.default_rng(seed)
    mask = rng.random(grid) < density
    mask[list(empty_rows), :] = False
    dense = rng.normal(size=(grid[0] * bs, grid[1] * bs)).astype(np.float32)
    return dense * np.kron(mask, np.ones((bs, bs), np.float32))


def _same(port: BCSR, ref) -> None:
    assert port.shape == tuple(ref.shape) and port.bs == ref.bs
    assert port.rows.dtype == torch.int32 and port.cols.dtype == torch.int32
    np.testing.assert_array_equal(port.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_array_equal(port.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))


CASES = [((3, 4), 128, 0.4, ()), ((2, 2), 128, 1.0, ()),
         ((5, 3), 16, 0.5, (1, 3)), ((4, 6), 16, 0.0, ()),
         ((6, 5), 32, 0.3, (0,))]


@pytest.mark.parametrize("grid,bs,density,empty", CASES)
def test_from_dense_todense_and_transpose_match_reference(grid, bs,
                                                          density, empty):
    dense = _dense(grid, bs, density, seed=sum(grid) + bs, empty_rows=empty)
    ref = rbs.BCSR.from_dense(dense, bs=bs)
    port = BCSR.from_dense(dense, bs=bs)
    _same(port, ref)
    assert port.nblocks == ref.nblocks >= 1
    assert port.block_sparsity == ref.block_sparsity
    assert port.nnz_fraction() == ref.nnz_fraction()
    np.testing.assert_array_equal(port.todense().numpy(),
                                  np.asarray(ref.todense()))
    _same(port.T, ref.T)
    np.testing.assert_array_equal(port.T.todense().numpy(), dense.T)


@pytest.mark.parametrize("grid,bs,density,empty", CASES)
def test_transpose_stays_row_major_and_rowptr_bounds_each_block_row(
        grid, bs, density, empty):
    port = BCSR.from_dense(_dense(grid, bs, density, seed=7,
                                  empty_rows=empty), bs=bs)
    for x in (port, port.T):
        key = x.rows.long() * (x.shape[1] // bs) + x.cols.long()
        assert bool((key[1:] > key[:-1]).all())          # strictly sorted
        mb = x.shape[0] // bs
        rp = x.rowptr
        assert rp.dtype == torch.int32 and tuple(rp.shape) == (mb + 1,)
        assert int(rp[0]) == 0 and int(rp[-1]) == x.nblocks
        counts = torch.bincount(x.rows.long(), minlength=mb)
        assert torch.equal((rp[1:] - rp[:-1]).long(), counts)
        assert x.rowptr is rp                            # kept on the object


def test_empty_matrix_keeps_one_block():
    dense = np.zeros((256, 384), np.float32)
    _same(BCSR.from_dense(dense, bs=128), rbs.BCSR.from_dense(dense, 128))


@pytest.mark.parametrize("shape,bs", [((130, 257), 128), ((128, 128), 128),
                                      ((17, 3), 16)])
def test_pad_to_blocks_matches_reference(shape, bs):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = pad_to_blocks(x, bs)
    want = np.asarray(rbs.pad_to_blocks(x, bs))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pad_to_blocks(torch.tensor(x), bs).numpy(),
                                  want)


def test_ratings_match_reference_exactly():
    ref = ref_data.ratings(384, 256, rank=4, bs=128, block_density=0.5,
                           seed=6)
    port = data.ratings(384, 256, rank=4, bs=128, block_density=0.5, seed=6,
                        device="cpu")
    _same(port, ref)


def test_to_bcsr_carries_the_reference_and_moves_devices():
    ref = ref_data.ratings(256, 384, rank=3, bs=128, block_density=0.6,
                           seed=2)
    port = to_bcsr(ref, device="cpu")
    _same(port, ref)
    assert to_bcsr(port, device="cpu") is port
    assert port.to("cpu") is port
    moved = port.to("meta")
    assert moved.device.type == "meta" and moved.shape == port.shape


C = PIECE_BLOCKS
#: block rows of 0, 1, C - 1, C, C + 1, 2C, 2C + 1 and 3C + 5 blocks
ROW_LENGTHS = (0, 1, C - 1, C, C + 1, 2 * C, 2 * C + 1, 3 * C + 5)


def _long_rows(bs=16, seed=5):
    rng = np.random.default_rng(seed)
    nbc = max(ROW_LENGTHS) + 3
    mask = np.zeros((len(ROW_LENGTHS), nbc), bool)
    for r, n in enumerate(ROW_LENGTHS):
        mask[r, rng.permutation(nbc)[:n]] = True
    dense = rng.normal(size=(mask.shape[0] * bs, nbc * bs)).astype(np.float32)
    return dense * np.kron(mask, np.ones((bs, bs), np.float32))


def _check_pieces(x: BCSR) -> None:
    table, ptr = x.pieces
    mb = x.shape[0] // x.bs
    rp = x.rowptr.long()
    assert table.dtype == ptr.dtype == torch.int32
    assert tuple(ptr.shape) == (mb + 1,) and table.shape[1] == 3
    assert int(ptr[0]) == 0 and int(ptr[-1]) == table.shape[0]
    row, first, end = (table[:, c].long() for c in range(3))
    # every block exactly once, in order: the pieces tile 0..nblocks
    assert int(first[0]) == 0 and int(end[-1]) == x.nblocks
    assert torch.equal(first[1:], end[:-1])
    assert bool((end >= first).all()) and bool((end - first <= C).all())
    # a piece never crosses its block row, and each row's pieces are
    # ptr[i]:ptr[i + 1]; an empty row has one empty piece
    assert bool((first >= rp[row]).all()) and bool((end <= rp[row + 1]).all())
    per = (ptr[1:] - ptr[:-1]).long()
    assert torch.equal(row, torch.repeat_interleave(torch.arange(mb), per))
    lens = rp[1:] - rp[:-1]
    assert torch.equal(per, torch.clamp(-(-lens // C), min=1))
    empty = lens == 0
    assert torch.equal(per[empty], torch.ones_like(per[empty]))
    assert bool((end - first > 0)[~empty[row]].all())
    assert x.pieces is x.pieces                       # kept on the object


@pytest.mark.parametrize("grid,bs,density,empty", CASES)
def test_piece_table_tiles_every_block_row(grid, bs, density, empty):
    port = BCSR.from_dense(_dense(grid, bs, density, seed=11,
                                  empty_rows=empty), bs=bs)
    for x in (port, port.T):
        _check_pieces(x)


def test_piece_table_splits_long_rows_and_matches_the_transpose():
    dense = _long_rows()
    x = BCSR.from_dense(dense, bs=16)
    _check_pieces(x)
    counts = (x.pieces.ptr[1:] - x.pieces.ptr[:-1]).tolist()
    assert counts == [1, 1, 1, 1, 2, 2, 3, 4]
    # a row of L blocks in P pieces of near-equal length, in block order
    sizes = (x.pieces.table[:, 2] - x.pieces.table[:, 1]).tolist()
    want = []
    for n in ROW_LENGTHS:
        p = max(1, -(-n // C))
        want += [(q + 1) * n // p - q * n // p for q in range(p)]
    assert sizes == want
    assert want[4:6] == [C // 2, C // 2 + 1]                  # C + 1 blocks
    # Xᵀ by transposing the BCSR and by building it from the dense Xᵀ
    xt, built = x.T, BCSR.from_dense(np.ascontiguousarray(dense.T), bs=16)
    _check_pieces(xt)
    for a, b in zip(xt.pieces, built.pieces):
        assert torch.equal(a, b)
    moved = x.to("meta")
    assert all(t.device.type == "meta" for t in moved.pieces)


# --------------------------------------------------------------------------
# the block-row partition of distributed segments
# --------------------------------------------------------------------------

#: (grid, bs, density, empty block rows, parts): parts that divide the
#: block rows, with empty rows and whole empty parts among them
SHARD_CASES = [((8, 4), 16, 0.4, (), 4), ((16, 4), 128, 0.05, (), 8),
               ((12, 3), 16, 0.5, (0, 1, 2), 4), ((6, 5), 32, 0.3, (5,), 2),
               ((8, 2), 16, 0.0, (), 8), ((4, 4), 16, 1.0, (), 4)]


@pytest.mark.parametrize("grid,bs,density,empty,parts", SHARD_CASES)
def test_partition_block_rows_matches_reference_bit_for_bit(
        grid, bs, density, empty, parts):
    dense = _dense(grid, bs, density, seed=3 * sum(grid) + parts,
                   empty_rows=empty)
    ref = rbs.partition_block_rows(rbs.BCSR.from_dense(dense, bs=bs), parts)
    port = partition_block_rows(BCSR.from_dense(dense, bs=bs), parts)
    assert isinstance(port, ShardedBCSR)
    assert (port.shape, port.bs, port.nparts) == \
        (tuple(ref.shape), ref.bs, ref.nparts)
    for name in ("data", "rows", "cols"):
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port.todense().numpy(), dense)
    _same(port.unshard(), ref.unshard())
    for part in range(parts):
        want = rbs.ShardedBCSR(ref.data[part:part + 1],
                               ref.rows[part:part + 1],
                               ref.cols[part:part + 1], ref.shape, ref.bs,
                               ref.nparts).local_bcsr()
        local = port.local_bcsr(part)
        assert local.shape == (dense.shape[0] // parts, dense.shape[1])
        _same(local, want)
    _same(to_sharded_bcsr(ref, device="cpu").local_bcsr(0),
          port.local_bcsr(0))


@pytest.mark.parametrize("grid,bs,parts", [((12, 4), 16, 8), ((6, 2), 32, 4),
                                           ((3, 3), 16, 2)])
def test_indivisible_block_rows_do_not_partition(grid, bs, parts):
    dense = _dense(grid, bs, 0.5, seed=41)
    assert rbs.partition_block_rows(rbs.BCSR.from_dense(dense, bs=bs),
                                    parts) is None
    x = BCSR.from_dense(dense, bs=bs)
    assert partition_block_rows(x, parts) is None
    assert block_row_panel(x, parts, 0) is None
    assert partition_block_rows(x, 1) is None


@pytest.mark.parametrize("grid,bs,density,empty,parts", SHARD_CASES)
def test_block_row_panel_is_the_partition_without_padding(
        grid, bs, density, empty, parts):
    """A rank's block rows of a whole BCSR: a view of its blocks, equal to
    the partition's part less its padding blocks (or one zero block where
    the part has none), with the part's block-row pointer."""
    dense = _dense(grid, bs, density, seed=3 * sum(grid) + parts,
                   empty_rows=empty)
    x = BCSR.from_dense(dense, bs=bs)
    sharded = partition_block_rows(x, parts)
    pm = dense.shape[0] // parts
    for part in range(parts):
        panel = block_row_panel(x, parts, part)
        assert panel.shape == (pm, dense.shape[1])
        np.testing.assert_array_equal(
            panel.todense().numpy(), dense[part * pm:(part + 1) * pm])
        np.testing.assert_array_equal(panel.todense().numpy(),
                                      sharded.local_bcsr(part)
                                      .todense().numpy())
        local_rows = (x.rows.numpy() // (grid[0] // parts)) == part
        k = int(local_rows.sum())
        if k:
            assert panel.data.data_ptr() == \
                x.data[int(np.argmax(local_rows))].data_ptr()   # a view
            np.testing.assert_array_equal(
                panel.data.numpy(), sharded.data[part, :k].numpy())
            np.testing.assert_array_equal(
                panel.rows.numpy(), sharded.rows[part, :k].numpy())
        else:
            assert panel.nblocks == 1 and not panel.data.any()
        assert panel.rowptr.numpy().tolist() == BCSR(
            panel.data, panel.rows, panel.cols, panel.shape,
            bs).rowptr.numpy().tolist()
