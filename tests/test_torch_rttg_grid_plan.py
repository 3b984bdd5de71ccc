"""B1g's launch plan (``kernels/rttg_latency.py::grid_plan``) on the CPU.

The plan picks, for G lanes of N clients and R RSUs on a card of ``sms``
SMs that holds ``per_sm`` blocks of ``GRID_TILE_THREADS`` threads each
resident, the tiles a lane T, the threads a block and the clients a thread.
It keeps one block a lane below ``GRID_SPREAD_MIN`` clients and above
``GRID_POLL_RSU_MAX`` RSUs.  The kernel (``csrc/rttg_latency.cu``,
``rttg_latency_grid_tiles_kernel``) gives tile b of a lane the clients
``[b N // T, (b + 1) N // T)`` and thread ``tid`` the tile's clients ``tid,
tid + threads, ...``, at most ``GRID_PER_THREAD`` of them; ``_clients``
below walks that mapping.  No card is needed.
"""
import re
from pathlib import Path

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container has no hypothesis wheel: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro_torch.kernels import rttg_latency as rttg_mod
from repro_torch.kernels.rttg_latency import (GRID_PER_THREAD, GRID_POLL_RSU_MAX,
                                              GRID_SPREAD_MIN, GRID_TILE_THREADS, grid_plan)

SMS = 132  # an H100 SXM's SMs
CU = Path(rttg_mod.__file__).resolve().parent / "csrc" / "rttg_latency.cu"


def _clients(n, tiles, threads):
    """Each client's (tile, thread, slot) under the kernel's mapping, as a
    flat array of the client indices every (tile, thread, slot) takes (-1
    where the slot lies past its tile)."""
    b = np.arange(tiles)[:, None, None]
    tid = np.arange(threads)[None, :, None]
    c = np.arange(GRID_PER_THREAD)[None, None, :]
    lo, hi = b * n // tiles, (b + 1) * n // tiles
    j = lo + tid + c * threads
    return np.where(j < hi, j, -1).ravel()


def _check_plan(G, n, R, per_sm, spread_min=GRID_SPREAD_MIN):
    tiles, threads, per_thread = grid_plan(G, n, R, SMS, per_sm, spread_min)
    # covers every client of a lane exactly once (every lane has the same plan)
    taken = _clients(n, tiles, threads)
    taken = taken[taken >= 0]
    assert np.array_equal(np.sort(taken), np.arange(n)), (G, n, R, per_sm)
    # whole warps, at most 1,024 threads, at most four clients a thread
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert 1 <= per_thread <= GRID_PER_THREAD
    assert threads * per_thread >= -(-n // tiles)
    assert 1 <= tiles <= n
    if n <= 32 or n < spread_min or R > GRID_POLL_RSU_MAX:
        assert tiles == 1
    if tiles > 1:
        # every block resident at once (the cooperative launch), none empty
        assert tiles * G <= SMS * per_sm
        assert threads <= GRID_TILE_THREADS
    # the blocks cover the SMs wherever a lane is spread and residency allows:
    # the tiles that covering asks for fit the resident blocks, at a block
    # size the cap takes
    want = min(-(-SMS // G), -(-n // 32))
    cap = SMS * per_sm // G
    if (n >= spread_min and R <= GRID_POLL_RSU_MAX and want <= cap
            and -(-n // (GRID_TILE_THREADS * GRID_PER_THREAD)) <= cap):
        assert tiles * G >= min(SMS, G * -(-n // 32)), (G, n, R, per_sm, tiles)
    return tiles, threads, per_thread


# spread_min 33: the spread plan that chip_smoke.py's b1g_plan_crossover times
# against one block a lane.  R over [1, 32,768], half the draws at most 40 (around
# the 32 RSUs of a tiled lane)
@settings(max_examples=300, deadline=None)
@given(G=st.integers(1, 200), n=st.integers(1, 4096), r_low=st.integers(1, 40),
       r_any=st.integers(1, 32768), low=st.sampled_from([True, False]),
       per_sm=st.integers(1, 8), spread_min=st.sampled_from([33, GRID_SPREAD_MIN]))
def test_grid_plan_covers_each_client_once_within_residency(G, n, r_low, r_any, low, per_sm,
                                                           spread_min):
    _check_plan(G, n, r_low if low else r_any, per_sm, spread_min)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100, 255, 256, 257, 767, 768, 1023, 1024,
                               1025, 2048, 4095, 4096])
@pytest.mark.parametrize("G", [1, 2, 8, 24, 131, 132, 133, 200])
@pytest.mark.parametrize("R,per_sm", [(10, 1), (10, 6), (10, 8), (32, 6), (33, 6),
                                      (32768, 1)])
def test_grid_plan_at_its_edges(G, n, R, per_sm):
    """The plan's edges: one warp, the spread threshold, one block of 1,024
    threads, the four clients a thread of a full lane, one lane, more lanes
    than SMs, the RSUs one warp polls and one past them, a residency of one
    block an SM (R = 32,768) and of the card's 8."""
    tiles, threads, per_thread = _check_plan(G, n, R, per_sm)
    if G >= SMS or n < GRID_SPREAD_MIN or R > GRID_POLL_RSU_MAX:
        assert tiles == 1


@pytest.mark.parametrize("G,n,R,per_sm,plan", [
    (24, 20, 10, 6, (1, 32, 1)),       # the bench grid: one block a lane
    (8, 100, 10, 6, (1, 128, 1)),      # the streamed N = 100 grid: one block a lane
    (24, 767, 10, 6, (1, 768, 1)),     # below the spread threshold
    (24, 768, 10, 6, (6, 128, 1)),     # at it: 144 blocks
    (24, 2048, 10, 6, (8, 256, 1)),    # the N = 2,048 bench grid: a client a thread
    (24, 4096, 10, 6, (16, 256, 1)),
    (2, 4096, 10, 6, (66, 64, 1)),     # the greedy grid's lane group: 132 blocks
    (8, 4096, 10, 6, (17, 256, 1)),    # the streamed N = 4,096 grid
    (2, 4096, 40, 6, (1, 1024, 4)),    # past the RSUs one warp polls: one block a lane
    (24, 4096, 32768, 1, (1, 1024, 4)),
    (133, 4096, 10, 6, (1, 1024, 4)),  # more lanes than SMs: one block a lane
    (1, 33, 10, 6, (1, 64, 1)),
])
def test_grid_plan_at_the_main_paths_shapes(G, n, R, per_sm, plan):
    assert grid_plan(G, n, R, SMS, per_sm) == plan


def test_grid_plan_spreads_small_lanes_only_when_asked():
    """The spread plan that b1g_plan_crossover times (spread_min 33) against
    the default's one block a lane."""
    assert grid_plan(8, 100, 10, SMS, 6, spread_min=33) == (4, 32, 1)
    assert grid_plan(1, 33, 10, SMS, 6, spread_min=33) == (2, 32, 1)
    assert grid_plan(8, 100, 40, SMS, 6, spread_min=33) == (1, 128, 1)


def test_grid_plan_constants_are_the_kernels():
    src = CU.read_text()
    for name, value in (("GRID_PER_THREAD", GRID_PER_THREAD),
                        ("GRID_TILE_THREADS", GRID_TILE_THREADS),
                        ("POLL_RSU_MAX", GRID_POLL_RSU_MAX)):
        m = re.search(rf"#define {name} (\d+)", src)
        assert m is not None and int(m.group(1)) == value, name
    assert rttg_mod.GRID_MAX_N == GRID_PER_THREAD * 1024
