"""Fixed-shape sum-tree for prioritized replay sampling on the device.

Counterpart of the JAX package's ``ops/sum_tree.py`` (plain array code
there, no Pallas kernel; plain tensor code here). A complete binary tree
over a power-of-two leaf array, stored one tensor per level: ``levels[0]``
the ``(L,)`` leaf priorities up to ``levels[-1]`` the ``(1,)`` root, the
total mass. Every operation keeps its shapes fixed and reads nothing back
to the host, so the DQN step's priority update, stratified sample and
TD-error write-back stay on the device.

- :func:`set_priorities` writes a batch of leaves, then refreshes each
  touched ancestor as the sum of its two children, level by level: a
  duplicate index writes the same value twice instead of adding twice, and
  every touched node is exactly the sum of its children afterwards. The
  writes are in place.
- :func:`sample_stratified` descends the tree for a whole batch at once:
  stratum ``i`` looks for the mass ``(i + u_i) / batch * total``. A
  zero-priority leaf carries no mass; where float rounding lands a stratum
  on one anyway, it takes the highest-priority leaf instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class SumTree:
    """``levels[0]``: the (L,) leaf priorities; ``levels[k]``: the
    (L / 2^k,) internal sums; ``levels[-1]``: the (1,) root."""

    levels: list

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[0]

    @property
    def total(self) -> torch.Tensor:
        return self.levels[-1][0]

    @property
    def leaves(self) -> torch.Tensor:
        return self.levels[0]


def leaf_count(capacity: int) -> int:
    """The next power of two >= capacity (>= 1)."""
    if capacity < 1:
        raise ValueError(f"sum-tree capacity must be >= 1, got {capacity}")
    return 1 << (capacity - 1).bit_length() if capacity > 1 else 1


def from_leaves(leaves: torch.Tensor) -> SumTree:
    """The whole tree from a leaf tensor (the out-of-band reseed path)."""
    levels = [leaves.to(torch.float32).contiguous()]
    while levels[-1].shape[0] > 1:
        levels.append(levels[-1].reshape(-1, 2).sum(dim=1))
    return SumTree(levels=levels)


def create(capacity: int, device=None) -> SumTree:
    """An all-zero tree: every leaf massless, nothing to sample yet."""
    return from_leaves(torch.zeros((leaf_count(capacity),),
                                   dtype=torch.float32, device=device))


def set_priorities(tree: SumTree, idx: torch.Tensor, priority: torch.Tensor,
                   mask: torch.Tensor | None = None) -> SumTree:
    """``leaves[idx[i]] = priority[i]`` where ``mask[i]`` (elsewhere the
    slot's current value, so a masked row aliasing a live slot changes
    nothing), then the ancestors along the touched paths. In place; returns
    ``tree``."""
    levels = tree.levels
    idx = idx.to(torch.int64)
    priority = priority.to(torch.float32)
    if mask is not None:
        priority = torch.where(mask, priority, levels[0][idx])
    levels[0].index_put_((idx,), priority)
    pos = idx
    for k in range(1, len(levels)):
        pos = pos // 2
        levels[k].index_put_((pos,), levels[k - 1][2 * pos]
                             + levels[k - 1][2 * pos + 1])
    return tree


def sample_stratified(tree: SumTree, u: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stratified inverse-CDF sample of ``len(u)`` leaves in proportion to
    their priority, ``u`` the (batch,) uniforms in [0, 1) (the JAX module
    draws them from its key). Returns ``(idx, probs)``: the leaf indices
    (int64) and their probabilities ``p_leaf / total``. An all-zero tree
    gives index 0 with probability 0 (callers gate on readiness)."""
    levels = tree.levels
    batch = u.shape[0]
    total = tree.total
    strata = (torch.arange(batch, dtype=torch.float32, device=u.device)
              + u) / batch
    mass = strata * total
    node = torch.zeros((batch,), dtype=torch.int64, device=u.device)
    for k in range(len(levels) - 2, -1, -1):
        left = 2 * node
        left_sum = levels[k][left]
        go_left = mass < left_sum
        node = torch.where(go_left, left, left + 1)
        mass = torch.where(go_left, mass, mass - left_sum)
    leaf_p = levels[0][node]
    fallback = torch.argmax(levels[0])
    idx = torch.where(leaf_p > 0, node, fallback)
    probs = levels[0][idx] / torch.clamp(total, min=1e-30)
    return idx, probs


def is_weights(probs: torch.Tensor, size: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """Importance-sampling weights ``(N P(i))^-beta`` over the batch max;
    zero-probability rows get weight 0, never inf."""
    n = torch.clamp(size.to(torch.float32), min=1.0)
    safe = torch.clamp(probs, min=1e-30)
    w = torch.where(probs > 0, torch.pow(n * safe, -beta),
                    torch.zeros_like(probs))
    return w / torch.clamp(w.max(), min=1e-30)
