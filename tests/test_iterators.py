"""Iterator-semantics tests (reference test/atom_iterator.jl:11-85).

The reference pins visitation-order behavior of its ordered / random /
sparse-aware iterators directly.  The block engine's analogue is the
active-first visit order of the active pass: active blocks are visited
first (preserving the — possibly permuted — visit order), the pass loops
over those alone, and the skipped blocks trail in visit order.  These
tests pin that contract directly, plus the no-op / coverage edge cases
the reference covers for its iterators.
"""

import numpy as np
import jax.numpy as jnp

from coordinatedescent_jl_tpu.ops.block_cd import _active_first_order


def test_prefetch_order_active_first_in_visit_order():
    """order[:n_active] = exactly the active blocks, in ``border`` order
    (reference OrderedIterator semantics, atom_iterator.jl:11-30, lifted
    to block granularity)."""
    active = jnp.asarray([True, False, True, True, False, False, True])
    border = jnp.arange(7)
    order, n_active = _active_first_order(active, border)
    assert int(n_active) == 4
    np.testing.assert_array_equal(np.asarray(order[:4]), [0, 2, 3, 6])


def test_prefetch_order_respects_permutation():
    """A randomized ``border`` (reference RandomIterator,
    atom_iterator.jl:41-75) is honored: the active prefix is the active
    blocks in permuted order — each visited exactly once."""
    rng = np.random.default_rng(0)
    for seed in range(5):
        nb = 16
        active_np = rng.random(nb) < 0.4
        border_np = rng.permutation(nb)
        order, n_active = _active_first_order(jnp.asarray(active_np),
                                              jnp.asarray(border_np))
        k = int(n_active)
        assert k == int(active_np.sum())
        got = np.asarray(order[:k])
        want = [b for b in border_np if active_np[b]]
        np.testing.assert_array_equal(got, want)


def test_prefetch_order_tail_clamped_to_last_active():
    """Positions past n_active hold the skipped blocks in visit order; the
    pass never reaches them (its trip count is n_active) — the 'skip
    without touching X' half of the contract."""
    active = jnp.asarray([False, True, False, True, False, False])
    border = jnp.arange(6)
    order, n_active = _active_first_order(active, border)
    assert int(n_active) == 2
    np.testing.assert_array_equal(np.asarray(order), [1, 3, 0, 2, 4, 5])


def test_prefetch_order_no_active_blocks():
    active = jnp.zeros((5,), bool)
    order, n_active = _active_first_order(active, jnp.arange(5))
    assert int(n_active) == 0
    # nothing to visit: the order is the plain visit order, never entered
    np.testing.assert_array_equal(np.asarray(order), np.arange(5))
