"""The redesigned metering kernels (``csrc/segment_trapz.cu``), as far as
the CPU can reach them:

* ``segment_trapz``'s persistent plan (``trapz_plan`` / ``trapz_tiles``)
  and ``ordered_segment_sum``'s counting-sort plan (``sort_plan``), as
  functions of shapes alone, cover ``[0, N)`` once each at every size
  ``chip_smoke.py`` checks on the card;
* a plain-torch model of the counting sort as the kernels compute it
  (per-tile counts, the (key, tile) scan, the in-tile scatter ranking
  each entry among the earlier lanes and entries of its key:
  ``ref.counting_sort_positions``) puts every entry where a stable sort
  puts it;
* the wrappers' key, channel and alignment limits raise as documented;
* the plain versions the CPU path runs still agree with the JAX
  package (``segment_trapz`` in interpret mode, a Python running sum)
  at tile-boundary sizes;
* the planted faults ``chip_smoke.py`` holds the kernels' checks
  against (a ring read one tile late, each run summed in reverse, each
  run summed as a pairwise tree) fail a bit-equality check.

The kernels themselves need the card; ``chip_smoke.py`` holds them
against the plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet.carbon import make_trace
from repro.kernels import ref as jref
from repro.kernels import segment_trapz as jpl
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_trapz as cu

SMS = 132                                   # an H100 SXM
N_METER = 790_603                           # chip_smoke's acceptance sizes
N_SEG = 790_002
TILE = cu.TRAPZ_TILE
WAVE = cu.trapz_plan(10 ** 9, SMS).blocks * TILE
TRAPZ_SIZES = [1, 17, 2001, TILE - 1, TILE, TILE + 1, 3 * TILE + 1,
               WAVE - 1, WAVE, WAVE + 1, N_SEG - 1, N_SEG]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", TRAPZ_SIZES)
def test_trapz_plan_covers_every_entry_once(n):
    plan = cu.trapz_plan(n, SMS)
    assert 1 <= plan.blocks <= cu.TRAPZ_BLOCKS_PER_SM * SMS
    assert plan.blocks <= plan.tiles
    assert plan.full_tiles == n // TILE
    assert plan.tiles - plan.full_tiles == (1 if n % TILE else 0)
    seen = np.zeros(n, np.int64)
    tiles = []
    for blk in range(plan.blocks):
        mine = list(cu.trapz_tiles(plan, blk))
        assert mine == sorted(mine)
        # the partial tile, read with plain loads, is a block's last
        assert all(t < plan.full_tiles for t in mine[:-1])
        tiles += mine
        for t in mine:
            seen[t * TILE:min(n, (t + 1) * TILE)] += 1
    assert sorted(tiles) == list(range(plan.tiles))
    assert np.all(seen == 1)


@pytest.mark.parametrize("num", [1800, 15_000])
@pytest.mark.parametrize("n", [0, 1, 1000, 2048, 2049, N_METER])
def test_sort_plan_covers_every_entry_once(n, num):
    plan = cu.sort_plan(n, num)
    assert plan.tile % cu.SORT_TILE == 0 and plan.tile >= num
    assert plan.tiles == -(-n // plan.tile)
    assert (plan.tiles - 1) * plan.tile < n <= plan.tiles * plan.tile \
        or n == plan.tiles == 0
    # the histogram rows hold no more counters than a tile's entries
    # times the tiles (the scratch never outgrows the input much)
    assert plan.tiles * num <= plan.tiles * plan.tile


@pytest.mark.parametrize("n,num,hot", [
    (1, 1, None), (33, 3, None), (2047, 60, None), (2049, 60, None),
    (5000, 1800, None), (5000, 1800, 7), (4100, 5000, None)])
def test_counting_sort_model_equals_a_stable_sort(n, num, hot):
    rng = np.random.default_rng(n + num)
    keys = rng.integers(0, num, n)
    if hot is not None:
        keys[rng.random(n) < 0.9] = hot
    keys = _t(keys)
    tile = cu.sort_plan(n, num).tile
    pos = ref.counting_sort_positions(keys, num, tile)
    order = torch.sort(keys, stable=True).indices
    want = torch.empty_like(order)
    want[order] = torch.arange(n)
    assert torch.equal(pos, want)


@pytest.mark.parametrize("tile", [64, 512, 1024, 2048])
def test_counting_sort_model_ranks_across_tiles(tile):
    """Many tiles over few keys: the (key, tile) scan's offsets carry
    each key's run on across tiles in index order."""
    rng = np.random.default_rng(3)
    keys = _t(rng.integers(0, 5, 5000))
    pos = ref.counting_sort_positions(keys, 5, tile)
    order = torch.sort(keys, stable=True).indices
    assert torch.equal(order[pos], torch.arange(5000))


@pytest.mark.parametrize("num", [1, 1800, 15_000, cu.SORT_MAX_NUM])
def test_sort_limits_take_keys_up_to_the_limit(num):
    cu.sort_limits(N_METER, 2, num)


@pytest.mark.parametrize("n,C,num,msg", [
    (10, 2, cu.SORT_MAX_NUM + 1, "keys exceed"),
    (10, cu.SORT_MAX_C + 1, 4, "channels exceed"),
    (2 ** 31, 2, 4, "32-bit positions")])
def test_sort_limits_raise_beyond_the_design(n, C, num, msg):
    with pytest.raises(ValueError, match=msg):
        cu.sort_limits(n, C, num)


def test_trapz_align_check_refuses_a_view_off_the_16_byte_grid():
    x = torch.zeros(64, dtype=torch.float64)
    cu.trapz_align_check((x, x[2:]), ("a", "b"))         # 16-byte steps
    with pytest.raises(ValueError, match="16-byte aligned base"):
        cu.trapz_align_check((x, x[1:]), ("a", "b"))


@pytest.mark.parametrize("K,ok", [(1, False), (2, True), (49, True),
                                  (cu.MAX_KNOTS, True),
                                  (cu.MAX_KNOTS + 1, False)])
def test_knot_tables_within_the_unrolled_search(K, ok):
    if ok:
        cu._knots("segment_trapz", K)
    else:
        with pytest.raises(ValueError, match="knots"):
            cu._knots("segment_trapz", K)


def _jax(fn, *xs, **kw):
    with jax.enable_x64(True):
        return np.asarray(fn(*[jnp.asarray(x) for x in xs], **kw))


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 2 * TILE + 1])
def test_segment_trapz_at_tile_boundaries_matches_jax(n):
    trace = make_trace("solar-duck", 0.39)
    kt, kv, cum = (np.asarray(x, dtype=np.float64)
                   for x in (trace._kt, trace._kv, trace._cum))
    rng = np.random.default_rng(n)
    a = np.sort(rng.uniform(0.0, 1.2 * trace.period_s, n))
    b = a + rng.exponential(110.0, n)
    b[n // 2] = a[n // 2]                           # a zero-width entry
    w = rng.uniform(60.0, 700.0, n)
    got = ops.segment_trapz(*map(_t, (a, b, w, kt, kv, cum)),
                            period=trace.period_s).numpy()
    for fn, kw in ((jref.segment_trapz_ref, {}),
                   (jpl.segment_trapz, {"interpret": True})):
        want = _jax(fn, a, b, w, kt, kv, cum, period=trace.period_s, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert got[n // 2] == 0.0


@pytest.mark.parametrize("n,num", [(2047, 40), (2048, 40), (2049, 40),
                                   (4097, 3000)])
def test_ordered_segment_sum_at_tile_boundaries_is_a_running_sum(n, num):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, num, n)
    vals = rng.uniform(0.0, 5e5, (2, n))
    want = [[0.0] * num for _ in range(2)]
    for c in range(2):
        for k, v in zip(keys.tolist(), vals[c].tolist()):
            want[c][k] += v
    assert ops.ordered_segment_sum(_t(vals), _t(keys), num).tolist() == want


@pytest.mark.parametrize("hot", [None, 3])
def test_order_faults_fail_a_bit_equality_check(hot):
    rng = np.random.default_rng(11)
    n, num = 20_000, 60
    keys = rng.integers(0, num, n)
    if hot is not None:
        keys[rng.random(n) < 0.9] = hot
    vals, keys = _t(rng.uniform(0.0, 5e5, (2, n))), _t(keys)
    want = ref.ordered_segment_sum_ref(vals, keys, num)
    faults = ref.ordered_segment_sum_faults(vals, keys, num)
    assert set(faults) == {"reversed order", "pairwise sum"}
    for bad in faults.values():
        assert not torch.equal(bad, want)
        assert (bad != want).any(0).sum() > num // 2
        # the same sums in another order: close, not equal
        torch.testing.assert_close(bad, want, rtol=1e-12, atol=0)


def test_pairwise_fault_is_a_pairwise_tree():
    vals = _t(np.array([[1.0, 2.0, 3.0, 4.0, 5.0]]))
    keys = _t(np.array([0, 0, 0, 0, 0]))
    got = ref.ordered_segment_sum_faults(vals, keys, 1)["pairwise sum"]
    assert got.tolist() == [[((1.0 + 2.0) + (3.0 + 4.0)) + 5.0]]
    vals = _t(np.array([[1e16, 1.0, -1e16, 1.0]]))
    keys = _t(np.array([0, 0, 0, 0]))
    faults = ref.ordered_segment_sum_faults(vals, keys, 1)
    assert faults["pairwise sum"].tolist() == [[(1e16 + 1.0) + (-1e16 + 1.0)]]
    assert faults["reversed order"].tolist() == [[((1.0 - 1e16) + 1.0)
                                                 + 1e16]]


def test_ring_fault_shifts_ring_tiles_and_fails_the_check():
    want = torch.arange(5 * TILE + 7, dtype=torch.float64)
    plan = cu.trapz_plan(want.numel(), SMS)
    late = ref.segment_trapz_faults(want, TILE, plan.full_tiles)[
        "ring read one tile late"]
    assert torch.equal(late[:TILE], want[:TILE])
    assert torch.equal(late[TILE:5 * TILE], want[:4 * TILE])
    assert torch.equal(late[5 * TILE:], want[5 * TILE:])   # the tail
    assert int((late != want).sum()) == 4 * TILE
