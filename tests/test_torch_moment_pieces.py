"""The host side of the moment kernel's row split (ops/moments.py).

The wide form's staged path (34 <= C <= 128) cuts a block into pieces of
``piece_rows`` rows where the blocks are too few to fill the card; each
piece writes its own partial and the group sum adds a group's partials in
``partial_order``. These tests hold that plan in plain Python: every row of
a block lies in exactly one piece, the pieces come in row order, the
order of the sums is fixed, and the kernel's summation structure
(``grouped_moments_pieces_ref``) gives the JAX engine's f64 moments at the
tolerances of tests/test_torch_moments.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from polars_ols_tpu.ops import direct as jdirect  # noqa: E402

from polars_ols_tpu_torch.ops import moments  # noqa: E402

H100_SMS = 132


def _pieces(R, rows):
    """Row ranges of the pieces of a block of R rows, as the kernel reads
    them: piece p is rows [p rows, min(R, (p + 1) rows))."""
    return [(p * rows, min(R, (p + 1) * rows)) for p in range(moments.pieces(R, rows))]


@pytest.mark.parametrize("S,R,C", [
    (20, 512, 101),  # "large": one group of 20 blocks
    (1, 512, 41), (3, 37, 64), (2, 16, 34), (1, 1, 41), (65, 512, 128), (66, 512, 128),
    (1_280, 512, 41),  # "grouped_largek": enough blocks, no split
    (1, 512, 33), (1, 512, 6),  # the register forms never split
    (1, 512, 129), (4, 300, 1_001),  # nor does the direct form
])
def test_pieces_cover_every_row_once_in_order(S, R, C):
    rows = moments.piece_rows(S, R, C, H100_SMS)
    spans = _pieces(R, rows)
    assert spans[0][0] == 0 and spans[-1][1] == R
    assert all(a < b for a, b in spans)  # no empty piece
    assert all(spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1))  # contiguous, in order
    covered = np.zeros(R, dtype=np.int64)
    for a, b in spans:
        covered[a:b] += 1
    assert (covered == 1).all()
    split = len(spans) > 1
    if split:
        assert rows % moments.STAGE_ROWS == 0 and rows < R
        assert moments.MAX_REGISTER_COLS < C <= moments.MAX_STAGED_COLS
        assert S * len(spans) <= H100_SMS  # the CTAs fit the card in one wave
    assert split == (moments.MAX_REGISTER_COLS < C <= moments.MAX_STAGED_COLS and H100_SMS // S >= 2 and R > 16)


def test_large_is_cut_in_six_pieces():
    rows = moments.piece_rows(20, 512, 101, H100_SMS)
    assert (rows, moments.pieces(512, rows)) == (96, 6)


@pytest.mark.parametrize("n_pieces", [1, 2, 6])
def test_partial_order_is_block_then_piece(n_pieces):
    offsets = [0, 2, 2, 5, 6]  # a group without blocks in the middle
    order = moments.partial_order(offsets, n_pieces)
    assert len(order) == 4 and order[1] == []
    flat = [q for group in order for q in group]
    assert flat == list(range(6 * n_pieces))  # every partial once, blocks then their pieces
    for g, group in enumerate(order):
        blocks = [q // n_pieces for q in group]
        assert blocks == sorted(blocks) and set(blocks) == set(range(offsets[g], offsets[g + 1]))
    assert moments.partial_order(offsets, n_pieces) == order  # fixed: nothing depends on the data


@pytest.mark.parametrize("G,R,C,rows", [(3, 37, 35, 16), (2, 100, 41, 32), (1, 64, 101, 16), (4, 20, 48, 20)])
def test_piecewise_sums_match_jax_moments(G, R, C, rows):
    rng = np.random.default_rng(R + C)
    n_blocks = rng.integers(0, 4, size=G)
    n_blocks[0] = max(1, n_blocks[0])
    S = int(n_blocks.sum())
    Zp = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 2)
    wp = rng.random((S, R)) > 0.2
    Zp[~wp] = np.nan  # a masked slot's NaN never reaches a sum
    offsets = np.concatenate([[0], np.cumsum(n_blocks)])
    bg = np.repeat(np.arange(G), n_blocks)
    M_t, c_t = moments.grouped_moments_pieces_ref(
        torch.as_tensor(Zp), torch.as_tensor(wp), torch.as_tensor(offsets), G, rows
    )
    Zm = np.where(wp[..., None], Zp, 0.0)
    XtX_j, Xty_j, c_j = jdirect.grouped_moments(
        jnp.asarray(Zm[..., 1:]), jnp.asarray(Zm[..., 0]), jnp.asarray(wp), jnp.asarray(bg), G,
    )
    XtX_j, Xty_j = np.asarray(XtX_j), np.asarray(Xty_j)
    scale = np.abs(XtX_j).max()
    np.testing.assert_allclose(M_t[:, 1:, 1:].numpy(), XtX_j, rtol=1e-13, atol=1e-13 * scale)
    np.testing.assert_allclose(M_t[:, 1:, 0].numpy(), Xty_j, rtol=1e-13, atol=1e-13 * scale)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    ref, _ = moments.grouped_moments_blocks_ref(
        torch.as_tensor(Zp), torch.as_tensor(wp), torch.as_tensor(offsets), G
    )
    np.testing.assert_allclose(M_t.numpy(), ref.numpy(), rtol=1e-13, atol=1e-13 * float(ref.abs().max()))
