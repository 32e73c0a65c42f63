"""The fused update's launch plan, on the CPU.

``plan_update`` cuts a list of leaves into tiles of ``tile_units`` threads
times ``unit`` elements (8, or 4 for adam: ``UNITS``) and groups the leaves
into launches of at most
``MAX_LEAVES``; ``tile_span`` and ``tile_vectors`` below find a tile's
elements and each thread's 4-element vectors as the kernel does
(``csrc/fused_update.cu``, ``leaf_of`` and ``load_unit``). These tests walk
every vector of every tile of every launch and hold the plan to what the
kernel needs: every element updated exactly once, no tile reaching into
another leaf, tiles starting on unit boundaries and vectors on 4-element
ones (so a float4 of an f32 operand and 8 bytes of a bf16 one line up on
the same elements, and only a leaf's last ``size % 4`` elements go the
scalar way), a warp's vectors contiguous, and the launches split as the
kernel's by-value table allows. Each case runs at both units. The plan
depends on the sizes, the SM count and the unit, not on the grads' dtype:
f32 and bf16 operands take the same vectors.

The last tests hold the wrapper's per-call binding, which holds no tensor
and writes every leaf's current address on every call, to what the kernel
needs: a leaf whose storage was swapped is launched at its new address, and
one whose shape, dtype or strides changed in place raises.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from sharetrade_tpu_torch.models.core import tree_leaves
from sharetrade_tpu_torch.ops import fused_update as fu
from sharetrade_tpu_torch.ops.fused_update import (
    MAX_LEAVES, TILE_UNITS, UNITS, VEC, UpdatePlan, plan_update)

H100_SMS = 132
ODD = [0, 1, 3, 7, 8, 9, 1023, 1025]


def tile_span(plan: UpdatePlan, sizes: list[int], launch: int,
              tile: int) -> tuple[int, int, int]:
    """``(leaf, start, stop)``: the elements ``[start, stop)`` of leaf
    ``leaf`` that tile ``tile`` of launch ``launch`` updates, found as the
    kernel finds them: the last leaf of the launch whose first tile is at or
    before ``tile`` (the kernel counts such leaves with a warp ballot), and
    the tile's offset in it times ``tile_units * unit`` elements."""
    first, end = plan.launches[launch]
    base = plan.tile_start[first]
    leaf = first + sum(plan.tile_start[j] - base <= tile
                       for j in range(first, end)) - 1
    size = plan.tile_units * plan.unit
    start = (tile - (plan.tile_start[leaf] - base)) * size
    return leaf, start, min(start + size, sizes[leaf])


def tile_vectors(plan: UpdatePlan, sizes: list[int], launch: int,
                 tile: int) -> list[tuple[int, int, int, int]]:
    """``(thread, leaf, first element, valid elements)`` of every vector of
    a tile, as the kernel's threads take them: thread ``t`` the vectors at
    ``start + VEC * (h * tile_units + t)`` for ``h < unit // VEC``, each whole
    (``valid == VEC``: one vector access where the leaf is aligned), the
    leaf's tail (``0 < valid < VEC``: scalar accesses) or past the leaf's
    end (``valid == 0``: nothing)."""
    leaf, start, _ = tile_span(plan, sizes, launch, tile)
    out = []
    for t in range(plan.tile_units):
        for h in range(plan.unit // VEC):
            i = start + VEC * (h * plan.tile_units + t)
            out.append((t, leaf, i, max(0, min(VEC, sizes[leaf] - i))))
    return out


def _model_sizes(model):
    from sharetrade_tpu_torch.models.mlp import ac_mlp, q_mlp
    from sharetrade_tpu_torch.models.transformer_episode import (
        episode_transformer_policy)
    build = {
        "q_mlp": lambda: q_mlp(203, 200, 3, parity=False, device="cpu"),
        "ac_mlp": lambda: ac_mlp(203, 200, 3, device="cpu"),
        "flagship": lambda: episode_transformer_policy(
            203, 3, num_layers=2, num_heads=2, head_dim=128, device="cpu"),
    }[model]
    params = build().init(torch.Generator().manual_seed(0))
    return [p.numel() for p in tree_leaves(params)]


SETS = {
    **{f"size_{n}": [n] for n in ODD},
    "odd_sizes": ODD,
    "q_mlp": "q_mlp",
    "ac_mlp": "ac_mlp",
    "flagship": "flagship",
    # More leaves than one launch takes, of odd sizes.
    "70_leaves": [35] * 66 + [1, 3, 1000, 130 * 257],
    # A whole launch's worth of empty leaves between two launched ones.
    "130_leaves_empty_middle": [9] * 64 + [0] * 64 + [1025, 3],
    "all_empty": [0, 0, 0],
}


def _sizes(name):
    entry = SETS[name]
    return _model_sizes(entry) if isinstance(entry, str) else entry


def _walk(plan, sizes):
    """Coverage count of every element by the vectors, and every vector's
    (thread, leaf, first element, valid elements) as the kernel's threads
    take them."""
    cover = [np.zeros(n, dtype=np.int64) for n in sizes]
    vectors = []
    for launch, (first, end) in enumerate(plan.launches):
        n_tiles = plan.tile_start[end] - plan.tile_start[first]
        assert n_tiles > 0, "a launch without tiles"
        for tile in range(n_tiles):
            leaf, start, stop = tile_span(plan, sizes, launch, tile)
            assert first <= leaf < end, "a tile outside its launch's leaves"
            assert 0 <= start < stop <= sizes[leaf], \
                f"tile {tile} of launch {launch} reaches past leaf {leaf}"
            assert start % plan.unit == 0
            for t, lf, i, valid in tile_vectors(plan, sizes, launch, tile):
                assert lf == leaf
                if valid:
                    assert start <= i and i + valid <= stop
                cover[leaf][i:i + valid] += 1
                vectors.append((t, leaf, i, valid))
    return cover, vectors


@pytest.mark.parametrize("unit", sorted(set(UNITS.values())))
@pytest.mark.parametrize("name", list(SETS))
def test_every_element_is_updated_exactly_once(name, unit):
    sizes = _sizes(name)
    plan = plan_update(sizes, H100_SMS, unit)
    cover, _ = _walk(plan, sizes)
    for leaf, c in enumerate(cover):
        assert (c == 1).all(), f"leaf {leaf}: elements covered {set(c)}"


@pytest.mark.parametrize("unit", sorted(set(UNITS.values())))
@pytest.mark.parametrize("name", list(SETS))
def test_vectors_start_on_4_element_boundaries(name, unit):
    """Each leaf has ``size // 4`` whole vectors (one access each where
    the leaf is aligned) and one of ``size % 4`` elements (the scalar
    tail) when that is not 0."""
    sizes = _sizes(name)
    _, vectors = _walk(plan_update(sizes, H100_SMS, unit), sizes)
    for leaf, n in enumerate(sizes):
        mine = [(i, valid) for _, lf, i, valid in vectors
                if lf == leaf and valid]
        assert all(i % VEC == 0 for i, _ in mine)
        assert sum(valid == VEC for _, valid in mine) == n // VEC
        assert [valid for _, valid in mine if valid < VEC] == (
            [n % VEC] if n % VEC else [])


@pytest.mark.parametrize("unit", sorted(set(UNITS.values())))
@pytest.mark.parametrize("name", ["q_mlp", "flagship", "odd_sizes"])
def test_a_warps_vectors_are_contiguous(name, unit):
    """Within a tile, the first vectors of threads 0..31 cover one
    contiguous run of 128 elements, and so do their second vectors (if
    any): each warp instruction of the kernel moves one contiguous run."""
    sizes = _sizes(name)
    plan = plan_update(sizes, H100_SMS, unit)
    for launch, (first, end) in enumerate(plan.launches):
        for tile in range(plan.tile_start[end] - plan.tile_start[first]):
            vecs = tile_vectors(plan, sizes, launch, tile)
            nv = plan.unit // VEC
            for warp in range(plan.tile_units // 32):
                for h in range(nv):
                    starts = [i for t, _, i, _ in vecs[h::nv]
                              if warp * 32 <= t < warp * 32 + 32]
                    assert starts == list(range(starts[0],
                                                starts[0] + 32 * VEC, VEC))


@pytest.mark.parametrize("unit", sorted(set(UNITS.values())))
@pytest.mark.parametrize("name", list(SETS))
def test_launches_split_by_the_table_size(name, unit):
    """Launches take consecutive groups of at most MAX_LEAVES leaves,
    starting at a multiple of it, in order; a group without a tile is not
    launched, every leaf with elements is in a launch."""
    sizes = _sizes(name)
    plan = plan_update(sizes, H100_SMS, unit)
    groups = [(f, min(f + MAX_LEAVES, len(sizes)))
              for f in range(0, len(sizes), MAX_LEAVES)]
    assert list(plan.launches) == [g for g in groups if sum(sizes[g[0]:g[1]])]
    launched = {j for first, end in plan.launches for j in range(first, end)}
    assert {j for j, n in enumerate(sizes) if n} <= launched
    assert len(plan.tile_start) == len(sizes) + 1
    assert all(b >= a for a, b in zip(plan.tile_start, plan.tile_start[1:]))


@pytest.mark.parametrize("unit", sorted(set(UNITS.values())))
@pytest.mark.parametrize("name", list(SETS))
def test_tiles_spread_over_the_sms(name, unit):
    """The largest block size whose tiles number at least the SMs; the
    smallest when no size has that many."""
    sizes = _sizes(name)
    plan = plan_update(sizes, H100_SMS, unit)

    def tiles(t):
        return sum(-(-(-(-n // unit)) // t) for n in sizes)

    assert plan.tile_units in TILE_UNITS
    assert plan.tile_start[-1] == tiles(plan.tile_units)
    fits = [t for t in TILE_UNITS if tiles(t) >= H100_SMS]
    assert plan.tile_units == (fits[0] if fits else TILE_UNITS[-1])


def test_main_path_plans():
    """The two main paths' sets: the flagship's 34 leaves in one launch of
    128-thread tiles; the reference Q-network's 4 leaves in one launch of
    tiles small enough to reach every SM."""
    flagship = plan_update(_model_sizes("flagship"), H100_SMS,
                           UNITS["adagrad"])
    assert flagship.tile_units == 128 and flagship.launches == ((0, 34),)
    q = plan_update(_model_sizes("q_mlp"), H100_SMS, UNITS["adagrad"])
    assert q.launches == ((0, 4),) and q.tile_start[-1] >= H100_SMS


def _bound_set(optimizer="adagrad", sizes=(3, 1025, 8)):
    """A plan for CPU leaves of ``sizes`` (device index -1) with params,
    grads and moments bound as a call binds them."""
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(n, generator=gen) for n in sizes]
    grads = [torch.randn(n, generator=gen) for n in sizes]
    state = [[torch.rand(n, generator=gen) for n in sizes]
             for _ in range(fu._N_STATE[optimizer])]
    shapes = tuple(p.shape for p in params)
    plan = fu._Plan(optimizer, torch.float32, False, shapes, -1, H100_SMS)

    def bind():
        plan.bind("p", "param", params, torch.float32,
                  tuple(p.shape for p in params))
        plan.bind("g", "grads", grads, torch.float32)
        for j, leaves in enumerate(state):
            plan.bind(("s1", "s2")[j], f"state[{j}]", leaves, torch.float32)

    bind()
    return plan, params, grads, state, bind


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_binding_writes_every_leafs_current_address(optimizer):
    """Each call writes the addresses the leaves have now: a param given new
    storage by ``set_`` or ``.data =``, and a moment list replaced by new
    tensors, are launched at their new addresses."""
    plan, params, grads, state, bind = _bound_set(optimizer)
    assert list(plan.arrays["p"]) == [p.data_ptr() for p in params]
    assert list(plan.arrays["g"]) == [g.data_ptr() for g in grads]
    assert list(plan.arrays["s1"]) == [s.data_ptr() for s in state[0]]
    old = params[0].data_ptr()
    params[0].set_(torch.zeros_like(params[0]))
    params[1].data = torch.ones_like(params[1])
    state[-1][:] = [s.clone() for s in state[-1]]
    bind()
    assert plan.arrays["p"][0] == params[0].data_ptr() != old
    assert list(plan.arrays["p"]) == [p.data_ptr() for p in params]
    slot = ("s1", "s2")[len(state) - 1]
    assert list(plan.arrays[slot]) == [s.data_ptr() for s in state[-1]]


@pytest.mark.parametrize("change", ["resize_", "as_strided_", "data_dtype",
                                    "moment_resize_", "grad_view"])
def test_binding_refuses_a_leaf_changed_in_place(change):
    """A leaf whose shape, strides or dtype changed after the plan was built
    raises when it is bound, before any launch."""
    plan, params, grads, state, bind = _bound_set()
    if change == "resize_":
        params[1].resize_(1024)
    elif change == "as_strided_":
        params[2].as_strided_((8,), (0,))
    elif change == "data_dtype":
        params[2].data = params[2].double()
    elif change == "moment_resize_":
        state[0][0].resize_(4)
    else:
        grads[1] = torch.randn(2050)[::2]
    with pytest.raises(ValueError, match="shape|contiguous|float64"):
        bind()


def test_plan_holds_no_tensor():
    """A plan keeps only its ctypes tables: leaves bound through it are
    freed once their owner drops them."""
    plan, params, grads, state, bind = _bound_set()
    refs = [weakref.ref(t) for t in params + grads + state[0]]
    del params, grads, state, bind
    gc.collect()
    assert all(r() is None for r in refs)
    assert plan.call.unit == UNITS["adagrad"]
