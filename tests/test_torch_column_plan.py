"""The column streamers' launch plan (``kernels/fedavg_reduce.py::column_plan``)
on the CPU.

B2 / B2g (``csrc/fedavg_reduce.cu``) and B3 / B4 / B3g / B4g
(``csrc/server_update.cu``) launch a block a column tile of a lane: thread t
of tile b owns the runs ``(b * runs + u) * THREADS + t`` of ``vec`` columns,
u < ``runs``, and loads ``vec`` elements of each row at once.  The plan picks
the load width (the widest of 4, 2 and 1 elements that divides P and aligns
every operand) and the runs a thread (one, or the wide count that makes 16
bytes a thread a row where the lanes' tiles leave every SM ``FILL_PER_SM``
blocks).  ``_runs`` below walks the kernels' mapping.  No card is needed.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container has no hypothesis wheel: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro_torch.kernels import fedavg_reduce as fedavg_mod
from repro_torch.kernels import server_update as su_mod
from repro_torch.kernels.fedavg_reduce import (FILL_PER_SM, RUN_BYTES, THREADS, ColumnPlan,
                                               _vector_width, column_plan, column_tiles,
                                               wide_runs)

SMS = 132  # an H100 SXM's SMs
CSRC = Path(fedavg_mod.__file__).resolve().parent / "csrc"
CATALOG_P = (159_010, 1_070_794, 603_034)  # fl-mnist-mlp, fl-cifar10-cnn, fl-svhn-cnn


def _runs(P, plan):
    """Every (tile, thread, run) slot's run index under the kernels' mapping,
    -1 where the slot lies past the row."""
    b = np.arange(plan.tiles)[:, None, None]
    u = np.arange(plan.runs)[None, :, None]
    t = np.arange(THREADS)[None, None, :]
    run = (b * plan.runs + u) * THREADS + t
    return np.where(run < P // plan.vec, run, -1).ravel()


def _check_plan(lanes, P, vec, item, sms=SMS):
    plan = column_plan(lanes, P, vec, item, sms)
    assert isinstance(plan, ColumnPlan) and plan.vec == vec
    wide = wide_runs(vec, item)
    assert plan.runs in (1, wide)
    # the wide runs exactly where the lanes' tiles at that width fill the card
    if wide > 1:
        fills = lanes * column_tiles(P, vec, wide) >= FILL_PER_SM * sms
        assert (plan.runs == wide) == fills
    # 16 bytes a thread a row in a wide plan, whatever the element size and P
    if plan.runs == wide and vec * item <= RUN_BYTES:
        assert plan.runs * vec * item == RUN_BYTES
    # a block a tile: every run of the row taken exactly once, no tile empty
    taken = _runs(P, plan)
    taken = taken[taken >= 0]
    assert np.array_equal(np.sort(taken), np.arange(P // vec))
    assert plan.tiles == column_tiles(P, vec, plan.runs)
    tile = THREADS * plan.runs * vec
    assert (plan.tiles - 1) * tile < P <= plan.tiles * tile
    return plan


@settings(max_examples=300, deadline=None)
@given(lanes=st.integers(1, 65_535), p_runs=st.integers(1, 400_000),
       vec=st.sampled_from([1, 2, 4]), item=st.sampled_from([2, 4]),
       sms=st.sampled_from([1, 66, 132]))
def test_column_plan_covers_each_run_once(lanes, p_runs, vec, item, sms):
    _check_plan(lanes, p_runs * vec, vec, item, sms)


@pytest.mark.parametrize("item", [2, 4])
@pytest.mark.parametrize("lanes", [1, 2, 24, 40, 131, 65_535])
@pytest.mark.parametrize("P,vec", [(P, vec) for P in (1, 7, 8, 513, 4097, 4098, *CATALOG_P)
                                   for vec in (1, 2, 4) if P % vec == 0])
def test_column_plan_at_its_edges(P, vec, lanes, item):
    """One column, a ragged last tile, one lane and the grids' lane counts,
    every load width that divides P on both row types, the catalog's P."""
    _check_plan(lanes, P, vec, item)


@pytest.mark.parametrize("lanes,P,item,runs,tiles", [
    (1, 159_010, 4, 1, 622),      # B2 / B3 / B4 at the main path: one run, 4.7 blocks an SM
    (1, 159_010, 2, 1, 622),      # ... on bf16 rows
    (1, 1_070_794, 4, 2, 2092),   # B2 at fl-cifar10-cnn: 16 bytes a row
    (1, 1_070_794, 2, 4, 1046),
    (1, 603_034, 4, 2, 1178),     # B2 at fl-svhn-cnn
    (1, 603_034, 2, 4, 589),
    (24, 159_010, 4, 2, 311),     # the bench grid's B2g, the async grid's B4g
    (24, 159_010, 2, 4, 156),
    (40, 159_010, 4, 2, 311),     # the smoke grid's B3g
    (24, 1_070_794, 2, 4, 1046),  # the CIFAR-10 grid's B2g on bf16 rows
])
def test_column_plan_at_the_main_paths_shapes(lanes, P, item, runs, tiles):
    """The catalog's P are 2 mod 4: 2-element loads, so 2 runs a thread on
    fp32 rows and 4 on bf16 rows make the wide plan's 16 bytes a row."""
    assert column_plan(lanes, P, 2, item, SMS) == ColumnPlan(2, runs, tiles)


@pytest.mark.parametrize("P", CATALOG_P)
@pytest.mark.parametrize("lanes", [1, 24])
def test_bf16_rows_keep_as_many_bytes_in_flight_as_fp32_rows(lanes, P):
    """At every P's residue the wide plan loads as many bytes a thread a row
    from 2-byte rows as from 4-byte rows (and the vector width never exceeds
    16 bytes)."""
    for vec in (1, 2, 4):
        if P % vec == 0:
            f32, b16 = wide_runs(vec, 4) * vec * 4, wide_runs(vec, 2) * vec * 2
            assert b16 >= f32 and min(f32, b16) == RUN_BYTES


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("residue", [1, 2, 3, 5, 6, 7, 0, 4])
def test_load_width_divides_p_and_aligns_every_operand(residue, offset):
    """The load width the wrappers take: the widest of 4, 2 and 1 elements
    that divides P and aligns each operand's rows in its own element size
    (a bf16 row `offset` elements into its storage, an fp32 out aligned)."""
    P = 8 * 100 + residue
    rows = torch.empty(3 * P + offset, dtype=torch.bfloat16)[offset:].view(3, P)
    out = torch.empty(P)
    vec = min(_vector_width(rows, P), _vector_width(out, P))
    assert P % vec == 0
    assert rows.data_ptr() % (2 * vec) == 0 and out.data_ptr() % (4 * vec) == 0
    widest = max(v for v in (1, 2, 4) if P % v == 0 and offset % v == 0)
    assert vec == widest


def test_server_update_takes_the_same_plan():
    """B3 / B4 / B3g / B4g plan as B2 / B2g do (one ``column_plan``): the
    server wrapper's load width is the widest every operand allows."""
    P = 159_010
    u = torch.empty((24, 2, P))
    ops = [u, torch.empty((24, P), dtype=torch.bfloat16), torch.empty((24, P))]
    vec = min(_vector_width(x, P) for x in ops)
    assert vec == 2
    assert su_mod.column_plan is column_plan
    assert column_plan(24, P, vec, 4, SMS) == ColumnPlan(2, 2, 311)


def test_column_plan_constants_are_the_kernels():
    """THREADS and LOADS of both sources, and the wide runs' formula."""
    for name in ("fedavg_reduce.cu", "server_update.cu"):
        src = (CSRC / name).read_text()
        m = re.search(r"#define THREADS (\d+)", src)
        assert m is not None and int(m.group(1)) == THREADS, name
        m = re.search(r"#define LOADS (\d+)", src)
        # a group holds at least one row at the widest runs (8 a thread)
        assert m is not None and int(m.group(1)) % 8 == 0, name
        assert "16 / (VEC * (int)sizeof(E))" in src, name
    assert RUN_BYTES == 16
    assert max(wide_runs(v, i) for v in (1, 2, 4) for i in (2, 4)) == 8
