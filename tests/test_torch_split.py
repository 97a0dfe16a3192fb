"""The plan layer behind K1/K2's split of long groups and their padding skip.

``seg_slots`` must come out the same from ``make_plan`` and from the
reference's plan carried across with ``plan_from_numpy``, and must be the
tight count of leading slot rows of each 32-lane segment that hold anything
but padding (value 0 at column 0).  The work list must cover every step
exactly once, in order, within its group, at every piece size.  The kernels'
reading rule — each piece stops at its segments' counts, and the combine
sums the first ``ceil(count / P)`` pieces of a segment — must give the
plain version's result.

Skipping padding changes a result only where x is not finite at a skipped
column (the TPU kernel computes ``0·x[0]``); these tests use finite x.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import numpy_fields, rand_sparse, skewed

import repro.core.formats as ref_formats
import repro.kernels.ops as ref_ops
from repro_torch.core import from_dense, suite
from repro_torch.kernels import ops
from repro_torch.kernels.rgcsr_spmm import rgcsr_spmm_plain
from repro_torch.kernels.rgcsr_spmv import rgcsr_spmv_plain

torch.set_num_threads(1)

CPS_ALL = (1, 2, 4, 8)
PLANS = [("block", 0), ("adaptive", 0), ("adaptive", 6)]
SMALL = {spec.name: spec.build for spec in suite.small_corpus()}


def _stored_zeros():
    """Entries at columns 0 and 5 in many rows; ``_plans`` stores half of
    them as explicit zeros (those at column 0 are indistinguishable from
    padding, and skipped as such)."""
    a = rand_sparse(31, 300, 90, 0.05)
    a[::7, 0] = 1.0
    a[::3, 5] = 1.0
    return a


def _raj1_twin():
    return suite.paper_twins(256)["raj1_twin"]


EXTRA = {"skewed": lambda: skewed(3), "raj1_twin": _raj1_twin,
         "stored_zeros": _stored_zeros}


def _plans(a, ordering, spill, stored_zero=False):
    m = from_dense(a, "rgcsr", device="cpu")
    if stored_zero:    # true elements equal to 0.0
        vals = m.values.clone()
        for col in (0, 5):
            nz = torch.nonzero((m.columns == col) & (vals != 0)).flatten()
            vals[nz[::2]] = 0.0
        m = dataclasses.replace(m, values=vals)
    for cps in CPS_ALL:
        yield ops.make_plan(m, chunks_per_step=cps, ordering=ordering,
                            spill_threshold=spill)


def _seg_slots_by_loop(plan):
    """The counts, one group and segment at a time, from the definition."""
    vals = plan.values2d.float().numpy()
    cols = plan.columns2d.numpy()
    ptr = plan.group_step_ptr.numpy().astype(np.int64) * plan.rows_per_step
    n_seg = plan.group_size // ops.SEGMENT
    out = np.zeros((plan.n_groups, n_seg), np.int32)
    for g in range(plan.n_groups):
        for j in range(n_seg):
            lanes = slice(j * ops.SEGMENT, (j + 1) * ops.SEGMENT)
            live = ((vals[ptr[g]:ptr[g + 1], lanes] != 0)
                    | (cols[ptr[g]:ptr[g + 1], lanes] != 0)).any(1)
            if live.any():
                out[g, j] = np.flatnonzero(live)[-1] + 1
    return out


@pytest.mark.parametrize("ordering,spill", PLANS)
@pytest.mark.parametrize("name", sorted(SMALL) + sorted(EXTRA))
def test_slots_past_a_segment_count_are_padding(name, ordering, spill):
    """The count is tight: the slot row before it holds a real slot in the
    segment, and every slot row from it to the group's end is padding."""
    a = (SMALL.get(name) or EXTRA[name])()
    for plan in _plans(a, ordering, spill, stored_zero=name == "stored_zeros"):
        assert plan.seg_slots.dtype == torch.int32
        assert tuple(plan.seg_slots.shape) == (
            plan.n_groups, plan.group_size // ops.SEGMENT)
        np.testing.assert_array_equal(plan.seg_slots.numpy(),
                                      _seg_slots_by_loop(plan))


@pytest.mark.parametrize("cps", CPS_ALL)
@pytest.mark.parametrize("ordering,spill", PLANS)
@pytest.mark.parametrize("name", ["skewed", "raj1_twin"])
def test_seg_slots_same_from_make_plan_and_plan_from_numpy(name, ordering,
                                                           spill, cps):
    a = EXTRA[name]()
    kw = dict(chunks_per_step=cps, ordering=ordering, spill_threshold=spill)
    ref = ref_ops.make_plan(ref_formats.from_dense(a, "rgcsr"), **kw)
    fields = numpy_fields(ref)
    fields["seg_slots"] = np.zeros(1, np.int32)   # never taken from fields
    carried = ops.plan_from_numpy(fields, device="cpu")
    port = ops.make_plan(from_dense(a, "rgcsr", device="cpu"), **kw)
    np.testing.assert_array_equal(carried.seg_slots.numpy(),
                                  port.seg_slots.numpy())


def _piece_sizes(plan):
    """Every piece size from one step up to "no split"."""
    r = plan.rows_per_step
    longest = int(np.diff(plan.group_step_ptr.numpy()).max()) * r
    return sorted({r, 2 * r, 3 * r, 5 * r, -(-longest // 2 // r) * r or r,
                   longest, longest + r})


def _pieces_of(plan, tiles):
    """``(group, first slot row in the group, partial row or -1)`` of each
    K2 tile, read back from its first slot row and destination."""
    r, g_size = plan.rows_per_step, plan.group_size
    starts = plan.group_step_ptr.numpy().astype(np.int64) * r
    out = []
    for row0, dst in tiles[:, :2].astype(np.int64):
        if dst >= 0:
            g, part = dst // g_size, -1
        else:   # a split group has rows, so it ends the run of equal starts
            g = int(np.searchsorted(starts[:-1], row0, side="right")) - 1
            part = ~dst // g_size
        out.append((g, row0 - starts[g], part))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


@pytest.mark.parametrize("ordering,spill", PLANS)
@pytest.mark.parametrize("name", ["skewed", "raj1_twin"])
def test_work_list_covers_every_step_once_in_order(name, ordering, spill):
    a = EXTRA[name]()
    for plan in _plans(a, ordering, spill):
        r = plan.rows_per_step
        ptr = plan.group_step_ptr.numpy().astype(np.int64)
        step_group = plan.step_group.numpy()
        for p in _piece_sizes(plan):
            k1 = plan.work_list("rgcsr_spmv", n_sm=1, part_bytes=0,
                                piece_rows=p)
            work = plan.work_list("rgcsr_spmm", n_sm=1, part_bytes=0,
                                  piece_rows=p)
            assert work.piece_rows == k1.piece_rows == p
            tiles = work.items.numpy()
            # K2's tiles: the one-piece groups' first, then the split
            # groups', each in group order
            pieces = _pieces_of(plan, tiles)
            n_direct = work.n_direct
            assert (pieces[:n_direct, 2] == -1).all()
            assert (pieces[n_direct:, 2] >= 0).all()
            for part in (pieces[:n_direct], pieces[n_direct:]):
                assert (np.diff(part[:, 0] * 10**9 + part[:, 1]) > 0).all()
            items = pieces[np.lexsort((pieces[:, 1], pieces[:, 0]))]
            steps, parts, split_groups = [], [], []
            for g, first, part in items:
                n_steps = ptr[g + 1] - ptr[g]
                assert first % r == 0 and 0 <= first // r <= max(n_steps - 1,
                                                                  0)
                own = np.arange(ptr[g] + first // r,
                                min(ptr[g] + (first + p) // r, ptr[g + 1]))
                assert (step_group[own] == g).all()
                steps.extend(own)
                single = n_steps * r <= p
                assert (part == -1) == single
                if not single:
                    parts.append(part)
                    if first == 0:
                        split_groups.append((g, part))
            # every step once, in order; groups in order
            np.testing.assert_array_equal(steps, np.arange(plan.num_steps))
            # partial rows: 0..n_parts-1 in order; the combine lists each
            # split group with its first partial row
            np.testing.assert_array_equal(parts, np.arange(work.n_parts))
            assert k1.n_parts == work.n_parts
            for w in (k1, work):
                np.testing.assert_array_equal(
                    w.combine.numpy().reshape(-1, 2),
                    np.array(split_groups).reshape(-1, 2))
            if p > int(np.diff(ptr).max()) * r:
                assert work.n_parts == 0 and len(items) == plan.n_groups
            # K1's units: every segment of a one-piece group, and of a
            # split group's pieces the segments with rows in the piece,
            # each (first slot row, live rows, first lane, destination)
            n_seg = plan.group_size // ops.SEGMENT
            counts = plan.seg_slots.numpy()
            g_size = plan.group_size
            want = []
            for g, first, part in items:
                for j in range(n_seg):
                    if part >= 0 and counts[g, j] <= first:
                        continue
                    end = min(first + p, (ptr[g + 1] - ptr[g]) * r,
                              counts[g, j])
                    lane0 = j * ops.SEGMENT
                    dst = (g * g_size + lane0 if part < 0
                           else ~(part * g_size + lane0))
                    want.append((ptr[g] * r + first, max(end - first, 0),
                                 lane0, dst))
            np.testing.assert_array_equal(k1.items.numpy(),
                                          np.array(want).reshape(-1, 4))
            # K2's tiles: per piece, first slot row, destination and the
            # live rows of every segment
            want_tiles = [[ptr[g] * r + first,
                           g * g_size if part < 0 else ~(part * g_size)]
                          + [max(min(first + p, (ptr[g + 1] - ptr[g]) * r,
                                     counts[g, j]) - first, 0)
                             for j in range(n_seg)]
                          for g, first, part in pieces]
            np.testing.assert_array_equal(tiles,
                                          np.array(want_tiles).reshape(
                                              -1, 2 + n_seg))


def _split_product(plan, x, p):
    """K1's reading rule in numpy (K2's, at width d): each unit record of
    K1's work list sums its live slot rows of its 32 lanes into its
    destination; a split group's lane sums the partials of its first
    ceil(count / p) pieces."""
    vals = plan.values2d.float().numpy()
    cols = plan.columns2d.numpy()
    xs = x.numpy().reshape(x.shape[0], -1).astype(np.float64)
    g_size = plan.group_size
    work = plan.work_list("rgcsr_spmv", n_sm=1, part_bytes=0, piece_rows=p)
    count = np.repeat(plan.seg_slots.numpy(), ops.SEGMENT, axis=1)
    y = np.full((plan.n_groups * g_size, xs.shape[1]), np.nan)
    partial = np.full((work.n_parts * g_size, xs.shape[1]), np.nan)
    for row0, n_rows, lane0, dst in work.items.numpy().astype(np.int64):
        lanes = lane0 + np.arange(ops.SEGMENT)
        rows = np.arange(row0, row0 + n_rows)
        acc = np.stack([vals[rows, lane] @ xs[cols[rows, lane]]
                        for lane in lanes])
        if dst >= 0:
            y[dst:dst + ops.SEGMENT] = acc
        else:
            partial[~dst:~dst + ops.SEGMENT] = acc
    partial = partial.reshape(work.n_parts, g_size, xs.shape[1])
    for g, first in work.combine.numpy().reshape(-1, 2):
        n = -(-count[g] // p)
        for lane in range(g_size):
            y[g * g_size + lane] = partial[first:first + n[lane], lane].sum(0)
    return y


@pytest.mark.parametrize("d", [None, 3])
@pytest.mark.parametrize("name", ["raj1_twin", "stored_zeros"])
def test_split_reading_rule_gives_the_plain_result(name, d):
    """Every output row and every partial the combine reads was written (no
    NaN survives), and the sum equals the plain version's at every piece
    size."""
    a = EXTRA[name]()
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal(
        (a.shape[1],) if d is None else (a.shape[1], d)).astype(np.float32))
    for plan in _plans(a, "block", 0, stored_zero=name == "stored_zeros"):
        plain = rgcsr_spmv_plain if d is None else rgcsr_spmm_plain
        want = plain(plan.values2d, plan.columns2d, plan.step_group, x,
                     n_groups=plan.n_groups,
                     chunks_per_step=plan.chunks_per_step)
        want = want.numpy().reshape(plan.n_groups * plan.group_size, -1)
        for p in _piece_sizes(plan):
            got = _split_product(plan, x, p)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_piece_rule_and_its_workspace_cap():
    """The rule's piece is a whole number of steps, shrinks as the card
    grows down to its floor, and grows until the partial workspace fits the
    cap."""
    plan = next(_plans(_raj1_twin(), "block", 0))
    r = plan.rows_per_step
    rows = int(plan.stored_slots)
    small = plan.work_list("rgcsr_spmv", n_sm=1, part_bytes=4).piece_rows
    assert small % r == 0 and small >= rows / ops.CTAS_PER_SM
    assert plan.work_list("rgcsr_spmv", n_sm=10**6,
                          part_bytes=4).piece_rows == max(
        r, ops.MIN_PIECE_ROWS)
    per_part = ops.WORKSPACE_BYTES // 3
    capped = plan.work_list("rgcsr_spmm", n_sm=10**6, part_bytes=per_part)
    assert capped.piece_rows % r == 0
    assert capped.piece_rows > max(r, ops.MIN_PIECE_ROWS)
    assert capped.n_parts * per_part <= ops.WORKSPACE_BYTES
    with pytest.raises(ValueError, match="no work list"):
        plan.work_list("ell_spmv", n_sm=1, part_bytes=4)
    narrow = dataclasses.replace(plan, seg_slots=plan.seg_slots[:, :1])
    with pytest.raises(ValueError, match="plan arrays do not match"):
        narrow.work_list("rgcsr_spmv", n_sm=1, part_bytes=4)
    for bad in (0, r // 2, r + 1):
        with pytest.raises(ValueError, match="piece_rows"):
            plan.work_list("rgcsr_spmv", n_sm=1, part_bytes=4,
                           piece_rows=bad)
