"""K4's shape-only plan (sert_tpu_torch.ops.gather_rescore._plan) on the CPU.

The plan decides, from the shapes alone, how the bin-major rescore sweep
cuts a bin into row chunks, how its threads split into rows and pair
lanes, how many pairs a pass takes, whether all of R stays resident in
shared memory, and the grid and the index's scratch. The kernel trusts it
to cover every row of a chosen bin once and every (row, pair) output of a
bin once, within the card's shared memory; these walk the plan as the
kernel walks it (csrc/gather_rescore.cu, rescore_kernel), so they run
without a card.
"""

import pytest

torch = pytest.importorskip("torch")

from sert_tpu_torch.ops import gather_rescore as k4  # noqa: E402

SMS = 132   # the H100 SXM's streaming multiprocessors

# (Q, NB, n_bins, bw, d, elem): the serving shape (synthetic_1m_retrieval:
# 64 queries, 1012 bins of 128 at d 128) in fp32 and bf16 rows, the CLI's
# larger batch (256), bw 64, the card tests' d 48 and 512 at Q 1, 70, 300,
# an odd bw, bw 1, and the widest rows the previous kernel took (d 12288).
SHAPES = [(64, 1012, 7813, 128, 128, 4), (64, 1012, 7813, 128, 128, 2),
          (256, 1012, 7813, 128, 128, 4), (64, 1012, 15625, 64, 128, 4),
          (1, 13, 40, 128, 48, 4), (70, 13, 40, 64, 512, 4),
          (300, 13, 40, 128, 48, 2), (70, 13, 40, 128, 512, 2),
          (16, 5, 9, 100, 36, 4), (3, 4, 50, 1, 8, 4),
          (5, 3, 3, 64, 12288, 4)]


def _chunk_rows(plan, bw):
    """The rows each row chunk of a bin stages: chunk c from row c * rows,
    min(rows, bw - c * rows) of them (the kernel's load)."""
    return [range(c * plan.rows, c * plan.rows + min(plan.rows,
                                                      bw - c * plan.rows))
            for c in range(plan.chunks)]


def _cells(plan, nr, cnt):
    """The (row, pair) outputs of an item of nr rows and cnt pairs, as the
    threads take them: thread t has row t % rows and pair lane t // rows
    (< npl), and in each pass the pairs p0 + lane + u * npl, u < mine (the
    kernel's pass loop)."""
    out = []
    for p0 in range(0, cnt, plan.pairs_per_pass):
        np_ = min(plan.pairs_per_pass, cnt - p0)
        for t in range(k4.THREADS):
            row, pl = t % plan.rows, t // plan.rows
            if pl >= plan.npl or row >= nr:
                continue
            mine = -(-(np_ - pl) // plan.npl) if np_ > pl else 0
            assert mine <= k4.PAIRS_PER_THREAD
            out += [(row, p0 + pl + u * plan.npl) for u in range(mine)]
    return out


@pytest.mark.parametrize("Q,NB,n_bins,bw,d,elem", SHAPES)
def test_chunks_cover_each_row_of_a_bin_once(Q, NB, n_bins, bw, d, elem):
    plan = k4._plan(Q, NB, n_bins, bw, d, elem, SMS)
    rows = [r for chunk in _chunk_rows(plan, bw) for r in chunk]
    assert rows == list(range(bw))
    assert all(len(c) > 0 for c in _chunk_rows(plan, bw))
    assert 1 <= plan.rows <= min(bw, k4.THREADS)


@pytest.mark.parametrize("cnt", [1, 7, 16, 17, 64, 300, 630])
@pytest.mark.parametrize("Q,NB,n_bins,bw,d,elem", SHAPES)
def test_threads_take_each_output_of_an_item_once(Q, NB, n_bins, bw, d,
                                                  elem, cnt):
    plan = k4._plan(Q, NB, n_bins, bw, d, elem, SMS)
    assert plan.npl * plan.rows <= k4.THREADS
    for chunk in _chunk_rows(plan, bw):
        nr = len(chunk)
        assert sorted(_cells(plan, nr, cnt)) == [
            (r, p) for r in range(nr) for p in range(cnt)]


@pytest.mark.parametrize("Q,NB,n_bins,bw,d,elem", SHAPES)
def test_shared_memory_fits_the_card(Q, NB, n_bins, bw, d, elem):
    plan = k4._plan(Q, NB, n_bins, bw, d, elem, SMS)
    assert plan.m_bytes % 16 == 0
    assert plan.m_bytes >= plan.rows * (d + 4) * elem
    assert plan.stage_bytes == plan.m_bytes + 4 * k4.PAIR_IDS
    r_bytes = 4 * Q * d if plan.resident else 4 * plan.pairs_per_pass * d
    assert plan.smem == 2 * plan.stage_bytes + r_bytes
    assert plan.smem <= k4.SMEM_LIMIT
    if not plan.resident:
        assert 2 * plan.stage_bytes + 4 * Q * d > k4.SMEM_LIMIT
        assert (plan.pairs_per_pass == 1
                or 4 * plan.pairs_per_pass * d <= k4.R_BYTES)


@pytest.mark.parametrize("Q,NB,n_bins,bw,d,elem", SHAPES)
def test_grid_and_scratch(Q, NB, n_bins, bw, d, elem):
    plan = k4._plan(Q, NB, n_bins, bw, d, elem, SMS)
    per_sm = k4.SM_SMEM // (plan.smem + 1024)
    assert 1 <= plan.blocks <= SMS * max(1, min(4, per_sm))
    assert plan.blocks <= min(n_bins, Q * NB) * plan.chunks
    assert plan.scratch == 4 * n_bins + Q * NB + 1


def test_serving_shape_reads_each_bin_in_one_item():
    """At the serving shape a bin of fp32 rows is one item, R stays
    resident, and one block an SM walks the bins."""
    plan = k4._plan(64, 1012, 7813, 128, 128, 4, SMS)
    assert (plan.rows, plan.chunks, plan.resident, plan.blocks) == (
        128, 1, True, SMS)
    assert plan.pairs_per_pass == 16


def test_rows_too_wide_for_shared_memory_raise():
    with pytest.raises(ValueError, match="cannot stage rows"):
        k4._plan(4, 2, 3, 128, 24000, 4, SMS)
