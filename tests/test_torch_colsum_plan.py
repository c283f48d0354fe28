"""The plan and the summation order of ``csrc/colsum_bf16.cu`` (#6's bias
gradients) on the CPU.

``_build.colsum_plan`` is a pure function of (rows, cols, SM count): the
kernel takes its result, so these tests reason about the plan the card
runs.  ``kernel_utils.colsum_fixed_order`` is the kernel's order in
PyTorch (the card's sums equal it bit for bit: tests/test_torch_kernels.py);
here it is held to a thread-by-thread simulation of the kernel and to the
JAX reference sum ``jnp.sum(x.astype(jnp.float32), 0)``.  Inputs come from
``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu_torch.ops import _build
from sfc_vit_tpu_torch.ops.kernel_utils import colsum_fixed_order

ROWS = [1, 150, 2048, 2049, 32768]
COLS = [8, 256, 768, 2304]
#: The H100 SXM's 132 SMs and the H100 PCIe's 114.
SMS = [132, 114]


def _rows_of(plan, rows):
    """The rows each (slice, row lane) of the kernel's loop visits."""
    lanes_all = plan.row_lanes()
    out = []
    for s in range(plan.slices):
        end = min(rows, (s + 1) * plan.rows_per_slice)
        for j in range(lanes_all):
            out.append(np.arange(s * plan.rows_per_slice + j, end, lanes_all))
    return np.concatenate(out)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("rows", ROWS)
def test_plan_covers_every_row_once(rows, cols, sms):
    """Every row lies in exactly one (slice, row lane); the chunks cover
    every column; no slice is empty."""
    plan = _build.colsum_plan(rows, cols, sms)
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and 8 * plan.lanes <= cols
    assert plan.chunks(cols) * 8 * plan.lanes >= cols > (plan.chunks(cols) - 1) * 8 * plan.lanes
    assert plan.slices * plan.rows_per_slice >= rows
    assert (plan.slices - 1) * plan.rows_per_slice < rows or plan.slices == 1
    visited = _rows_of(plan, rows)
    assert np.array_equal(np.sort(visited), np.arange(rows))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("rows", ROWS)
def test_plan_fills_the_card_where_rows_allow(rows, cols, sms):
    """The plan takes at least the SM count's worth of blocks wherever the
    rows give each row lane a row that many times over (the notebook's
    2,048 rows of 256 columns: 256 blocks, not the first pass's 8)."""
    plan = _build.colsum_plan(rows, cols, sms)
    blocks = plan.chunks(cols) * plan.slices
    most = plan.chunks(cols) * -(-rows // plan.row_lanes())
    assert blocks >= min(sms, most)


def test_plan_refuses_ragged_columns():
    for cols in (0, 12, 7):
        with pytest.raises(ValueError, match="multiple of 8"):
            _build.colsum_plan(10, cols, 132)


def _simulate(x, plan):
    """csrc/colsum_bf16.cu thread by thread in numpy fp32: each row lane's
    rows in order, the warp butterfly (lane ^ 16, ^ 8, ... down to the
    column lanes), the 8 warps in order, then the slices (warp w of 32
    takes slices w, w + 32, ..., then the warps in order)."""
    x = x.float().numpy()
    rows, cols = x.shape
    lanes, slices, per = plan
    rw = 32 // lanes
    part = np.zeros((slices, cols), np.float32)
    for ch in range(plan.chunks(cols)):
        for s in range(slices):
            acc = np.zeros((256, 8), np.float32)
            for t in range(256):
                w, lane = divmod(t, 32)
                c = ch * 8 * lanes + 8 * (lane % lanes)
                if c < cols:
                    for r in range(s * per + w * rw + lane // lanes, min(rows, (s + 1) * per),
                                   8 * rw):
                        acc[t] = acc[t] + x[r, c:c + 8]
            o = 16
            while o >= lanes:
                acc = acc + acc[np.arange(256) ^ o]
                o //= 2
            for q in range(8 * lanes):
                c = ch * 8 * lanes + q
                if c < cols:
                    v = acc[q // 8, q % 8]  # warp 0's lane q // 8
                    for w in range(1, 8):
                        v = np.float32(v + acc[32 * w + q // 8, q % 8])
                    part[s, c] = v
    t = np.zeros((32, cols), np.float32)
    for s in range(slices):
        t[s % 32] = t[s % 32] + part[s]
    out = t[0].copy()
    for w in range(1, 32):
        out = out + t[w]
    return torch.from_numpy(out)


@pytest.mark.parametrize("rows, cols, sms", [(150, 24, 132), (70, 256, 4), (33, 8, 7),
                                             (300, 64, 3), (0, 16, 5), (9, 40, 114),
                                             (1, 8, 132), (2049, 24, 132), (700, 16, 1),
                                             (9000, 8, 132)])
def test_fixed_order_matches_the_kernel_simulated(rows, cols, sms):
    """The vectorised twin equals the kernel's order simulated thread by
    thread, bit for bit (``(9000, 8, 132)``: 36 slices, so some of the slice
    sum's warps take two)."""
    x = torch.from_numpy(np.random.default_rng(rows + cols).standard_normal(
        (rows, cols)).astype(np.float32) * 10)
    plan = _build.colsum_plan(rows, cols, sms)
    got = colsum_fixed_order(x, plan)
    assert torch.equal(got.view(torch.int32), _simulate(x, plan).view(torch.int32))


#: The notebook's two sums (db_out [2,048, 256], db_in [2,048, 768]) and
#: ragged ones.
SUM_SHAPES = [(2048, 256), (2048, 768), (2049, 24), (150, 256), (1, 768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, cols", SUM_SHAPES)
def test_fixed_order_matches_jax_sum(rows, cols, dtype):
    """The twin against JAX's fp32 column sum of the same (bf16-rounded)
    values.  Two fp32 sums of R terms in different orders differ by at most
    R x 2^-24 x sum_r |x[r, c]| in column c."""
    rng = np.random.default_rng(7 * rows + cols)
    x = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32) * 3).to(dtype)
    xf = x.float().numpy()
    want = np.asarray(jnp.sum(jnp.asarray(xf).astype(jnp.float32), 0))
    got = colsum_fixed_order(x, _build.colsum_plan(rows, cols, 132)).numpy()
    tol = rows * 2.0 ** -24 * np.abs(xf).sum(0)
    assert bool((np.abs(got - want) <= tol).all())
