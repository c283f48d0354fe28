"""The curve-local backward's window plan against JAX's rule, on the CPU.

#13 runs on the windowed instances of the flash backward kernels #10 and
#11 (``csrc/flash_bwd_dq_sm90.cu``, ``csrc/flash_bwd_dkv_sm90.cu``): a
block of 128 queries walks only the 64-key tiles of its window, a block of
128 keys only the 64-query tiles whose window holds it, both by
``csrc/sm90.cuh::local_tile_window``, whose arithmetic
``_build.local_tile_window`` repeats.  JAX's ``_bwd_kernel``
(``sfc_vit_tpu/ops/local_attention.py``) keeps the pair (i, j) where
``|i // block - j // block| <= halo`` and ``j < n`` (its ``in_range`` and
``col < n_actual``; the dense twin ``local_block_attention_xla`` draws
the same mask).  The window is symmetric, so one plan serves both sides.
"""

import numpy as np
import pytest

from sfc_vit_tpu_torch.ops import _build


def _tiles_meeting(rows: np.ndarray, n: int, block: int, halo: int) -> set:
    """The 64-row tiles of the other side holding a j < n that some row i
    of ``rows`` meets under JAX's rule."""
    j = np.arange(n)
    hit = np.zeros(n, dtype=bool)
    for qb in np.unique(rows // block):
        hit |= np.abs(j // block - qb) <= halo
    return set(np.unique(j[hit] // 64).tolist())


@pytest.mark.parametrize("n", [300, 700, 5000, 12288, 16384])
@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("block", [64, 128, 192])
def test_local_tile_window_walks_exactly_the_tiles_jax_keeps(block, halo, n):
    """For each 64-row tile the plan walks exactly the tiles that hold a
    pair JAX keeps, and no other; for each 128-row block of a kernel (two
    warpgroups, whose curve blocks differ where a 192 block straddles
    it) it walks the union of its tiles' windows, which is one range."""
    tiles = -(-n // 64)
    for t in range(tiles):
        lo, hi = _build.local_tile_window(t, 64, n, block, halo)
        rows = np.arange(64 * t, min(n, 64 * t + 64))
        assert set(range(lo, hi)) == _tiles_meeting(rows, n, block, halo), (t, lo, hi)
    for t in range(0, tiles, 2):
        lo, hi = _build.local_tile_window(t, 128, n, block, halo)
        rows = np.arange(64 * t, min(n, 64 * t + 128))
        assert set(range(lo, hi)) == _tiles_meeting(rows, n, block, halo), (t, lo, hi)


@pytest.mark.parametrize("n", [300, 700, 5000, 12288, 16384])
@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("block", [64, 128, 192])
def test_local_fwd_plan_keeps_exactly_the_pairs_jax_keeps(block, halo, n):
    """#12's plan (``csrc/flash_fwd_sm90.cu``'s windowed instance): a block
    of 128 queries walks the 128-key tiles ``_build.local_fwd_tiles``, and
    each of its two warpgroups (64 queries, one curve block) keeps the keys
    of those tiles inside ``_build.local_fwd_key_range``.  For every query
    below n the keys kept are exactly JAX's ``|i // block - j // block| <=
    halo, j < n``: none lost to the tile walk, none extra from the
    rounding out to 128 keys or from the other warpgroup's window."""
    j = np.arange(n)
    for q0 in range(0, n, 128):
        t0, t1 = _build.local_fwd_tiles(q0, n, block, halo)
        assert 0 <= t0 < t1 <= -(-n // 128)
        walked = np.arange(128 * t0, min(n, 128 * t1))
        for row0 in (q0, q0 + 64):
            rows = np.arange(row0, min(n, row0 + 64))
            if rows.size == 0:
                continue
            assert np.unique(rows // block).size == 1  # one curve block a warpgroup
            klo, khi = _build.local_fwd_key_range(row0, n, block, halo)
            kept = walked[(walked >= klo) & (walked < khi)]
            jax_keeps = j[np.abs(j // block - row0 // block) <= halo]
            assert np.array_equal(kept, jax_keeps), (q0, row0)


@pytest.mark.parametrize("n", [300, 1100, 5000, 16384])
@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("block", [64, 128, 192, 256])
def test_local_fwd_wide_walk_keeps_exactly_the_pairs_jax_keeps(block, halo, n):
    """#12's walk at Dh 128 and 256 (``csrc/flash_fwd_sm90.cu``'s wide
    windowed instance): a block of 128 queries walks the 64-key tiles
    ``_build.local_tile_window(q0 // 64, 128, ...)``, the union of its two
    warpgroups' windows, and each warpgroup (64 queries, one curve block)
    keeps the keys of those tiles inside ``_build.local_fwd_key_range``.
    For every query below n the keys kept are exactly JAX's ``|i // block -
    j // block| <= halo, j < n``; every tile wholly outside a warpgroup's
    range (kept out of its max and sum) holds no key JAX keeps for it; and
    a warpgroup whose 64 queries all lie past n leaves the walk."""
    j = np.arange(n)
    for q0 in range(0, n, 128):
        lo, hi = _build.local_tile_window(q0 // 64, 128, n, block, halo)
        assert 0 <= lo < hi <= -(-n // 64)
        walked = np.arange(64 * lo, min(n, 64 * hi))
        for row0 in (q0, q0 + 64):
            if row0 >= n:
                assert row0 == q0 + 64  # the second warpgroup leaves
                continue
            rows = np.arange(row0, min(n, row0 + 64))
            assert np.unique(rows // block).size == 1  # one curve block a warpgroup
            klo, khi = _build.local_fwd_key_range(row0, n, block, halo)
            kept = walked[(walked >= klo) & (walked < khi)]
            jax_keeps = j[np.abs(j // block - row0 // block) <= halo]
            assert np.array_equal(kept, jax_keeps), (q0, row0)
            for t in range(lo, hi):
                if 64 * t + 64 <= klo or 64 * t >= khi:
                    keys = np.arange(64 * t, min(n, 64 * t + 64))
                    assert not np.isin(keys, jax_keeps).any(), (q0, row0, t)
