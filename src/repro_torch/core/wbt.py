"""Weight-balanced tree (BB[alpha]) over unique attribute values.

This is the paper's "lightweight plug-in" (WoW §3.1): an order-statistic tree
[Nievergelt & Reingold 1973] storing every *unique* attribute value together
with subtree sizes, giving O(log n):

  * ``insert(value)``              — §3.2 line 18 (duplicates are no-ops),
  * ``rank(value)``                — Algorithm 5 ``GetRank``,
  * ``select(k)``                  — k-th smallest unique value,
  * ``window(value, half)``        — Algorithm 4 ``GetWindow``,
  * ``count_range(x, y)``          — Algorithm 5 ``FilteredSetCardinality``,
  * ``closest_in_range(v, x, y)``  — entry-point selection (Alg. 3 line 4).

Balancing uses the integer parameters (Delta, Gamma) = (3, 2) — the only
integer pair proven valid for weight-balanced trees (Hirai & Yamamoto 2011).
``weight(t) = size(t) + 1``.

The tree is a grow-only numpy arena (no per-node Python objects): ``val``,
``left``, ``right``, ``size``.  All paths are iterative; rotations are done
bottom-up along an explicit path stack.  The window/rank/select procedures
below are the rank-arithmetic formulation of the paper's Algorithms 4/5 —
identical outputs, single implementation shared by both (Appendix A notes the
two traversals can be fused; rank arithmetic is that fusion taken to its
logical end).
"""
from __future__ import annotations

import numpy as np

_NIL = -1
_DELTA = 3
_GAMMA = 2


class WBT:
    """Order-statistic weight-balanced tree over unique float values."""

    __slots__ = ("val", "left", "right", "size", "root", "n", "_cap")

    def __init__(self, capacity: int = 64):
        cap = max(int(capacity), 8)
        self.val = np.empty(cap, dtype=np.float64)
        self.left = np.full(cap, _NIL, dtype=np.int64)
        self.right = np.full(cap, _NIL, dtype=np.int64)
        self.size = np.zeros(cap, dtype=np.int64)
        self.root = _NIL
        self.n = 0  # number of nodes (== number of unique values)
        self._cap = cap

    # ------------------------------------------------------------------ utils
    def __len__(self) -> int:
        return self.n

    def _grow(self) -> None:
        new_cap = self._cap * 2
        self.val = np.resize(self.val, new_cap)
        for name in ("left", "right"):
            arr = np.full(new_cap, _NIL, dtype=np.int64)
            arr[: self._cap] = getattr(self, name)[: self._cap]
            setattr(self, name, arr)
        sz = np.zeros(new_cap, dtype=np.int64)
        sz[: self._cap] = self.size[: self._cap]
        self.size = sz
        self._cap = new_cap

    def _sz(self, t: int) -> int:
        return 0 if t == _NIL else int(self.size[t])

    def _update(self, t: int) -> None:
        self.size[t] = 1 + self._sz(int(self.left[t])) + self._sz(int(self.right[t]))

    # -------------------------------------------------------------- rotations
    def _rot_left(self, t: int) -> int:
        r = int(self.right[t])
        self.right[t] = self.left[r]
        self.left[r] = t
        self._update(t)
        self._update(r)
        return r

    def _rot_right(self, t: int) -> int:
        l = int(self.left[t])
        self.left[t] = self.right[l]
        self.right[l] = t
        self._update(t)
        self._update(l)
        return l

    def _balance(self, t: int) -> int:
        """Re-establish the BB[alpha] invariant at node ``t`` (post-insert)."""
        wl = self._sz(int(self.left[t])) + 1
        wr = self._sz(int(self.right[t])) + 1
        if wr > _DELTA * wl:  # right-heavy
            r = int(self.right[t])
            wrl = self._sz(int(self.left[r])) + 1
            wrr = self._sz(int(self.right[r])) + 1
            if wrl >= _GAMMA * wrr:  # double rotation
                self.right[t] = self._rot_right(r)
            return self._rot_left(t)
        if wl > _DELTA * wr:  # left-heavy
            l = int(self.left[t])
            wll = self._sz(int(self.left[l])) + 1
            wlr = self._sz(int(self.right[l])) + 1
            if wlr >= _GAMMA * wll:
                self.left[t] = self._rot_left(l)
            return self._rot_right(t)
        return t

    # ----------------------------------------------------------------- insert
    def insert(self, value: float) -> bool:
        """Insert a value; returns True if it was new (duplicates: §3.7)."""
        value = float(value)
        if self.root == _NIL:
            self._push_node(value)
            self.root = 0
            return True
        # walk down, remembering the path
        path: list[int] = []
        dirs: list[bool] = []  # True == went right
        t = self.root
        while t != _NIL:
            v = self.val[t]
            if value == v:
                return False  # duplicate — WBT stores unique values only
            path.append(t)
            right = value > v
            dirs.append(right)
            t = int(self.right[t]) if right else int(self.left[t])
        node = self._push_node(value)
        parent = path[-1]
        if dirs[-1]:
            self.right[parent] = node
        else:
            self.left[parent] = node
        # walk back up: update sizes, rebalance
        child = node
        for i in range(len(path) - 1, -1, -1):
            p = path[i]
            if dirs[i]:
                self.right[p] = child
            else:
                self.left[p] = child
            self._update(p)
            child = self._balance(p)
        self.root = child
        return True

    def _push_node(self, value: float) -> int:
        if self.n >= self._cap:
            self._grow()
        i = self.n
        self.val[i] = value
        self.left[i] = _NIL
        self.right[i] = _NIL
        self.size[i] = 1
        self.n += 1
        return i

    # ------------------------------------------------------- order statistics
    def contains(self, value: float) -> bool:
        t = self.root
        while t != _NIL:
            v = self.val[t]
            if value == v:
                return True
            t = int(self.right[t]) if value > v else int(self.left[t])
        return False

    def rank(self, value: float) -> int:
        """Number of unique values strictly less than ``value`` (Alg. 5)."""
        t = self.root
        r = 0
        while t != _NIL:
            v = self.val[t]
            if value > v:
                r += self._sz(int(self.left[t])) + 1
                t = int(self.right[t])
            elif value < v:
                t = int(self.left[t])
            else:
                r += self._sz(int(self.left[t]))
                return r
        return r

    def select(self, k: int) -> float:
        """k-th smallest unique value, 0-based. Requires 0 <= k < len."""
        if not (0 <= k < self.n):
            raise IndexError(f"select({k}) out of range, n={self.n}")
        t = self.root
        while True:
            ls = self._sz(int(self.left[t]))
            if k < ls:
                t = int(self.left[t])
            elif k == ls:
                return float(self.val[t])
            else:
                k -= ls + 1
                t = int(self.right[t])

    def count_le(self, value: float) -> int:
        """Number of unique values <= value."""
        t = self.root
        r = 0
        while t != _NIL:
            v = self.val[t]
            if value >= v:
                r += self._sz(int(self.left[t])) + 1
                t = int(self.right[t])
            else:
                t = int(self.left[t])
        return r

    def count_range(self, x: float, y: float) -> int:
        """Algorithm 5: number of unique values in [x, y]."""
        if y < x:
            return 0
        return self.count_le(y) - (self.rank(x))

    # ----------------------------------------------------------------- window
    def window(self, value: float, half: int) -> tuple[float, float]:
        """Algorithm 4 ``GetWindow``: value bounds of the window of size
        ``2*half`` halved by ``value``.

        ``w_min`` is the ``half``-th closest value strictly below ``value``
        (clipped to the dataset minimum), ``w_max`` the ``half``-th closest
        strictly above (clipped to the dataset maximum) — matching the worked
        examples of Figs. 2–3.  ``value`` need not be present in the tree
        (Alg. 1 computes windows before line 18 inserts the value).
        """
        u = self.n
        if u == 0:
            return (value, value)
        r = self.rank(value)
        present = self.contains(value)
        lo_idx = max(0, r - half)
        above_start = r + (1 if present else 0)
        hi_idx = min(u - 1, above_start + half - 1)
        if hi_idx < lo_idx:  # degenerate: tree smaller than window
            hi_idx = lo_idx
        w_min = self.select(lo_idx)
        w_max = self.select(hi_idx)
        # the window must always contain ``value`` itself so that the value
        # (and its duplicates) are admissible under the range filter.
        return (min(w_min, value), max(w_max, value))

    # ------------------------------------------------------------ entry point
    def closest_in_range(self, value: float, x: float, y: float) -> float | None:
        """Value in the tree closest to ``value`` among those in [x, y].

        Used for Alg. 3 line 4 (entry point near the median of the filter)
        and Alg. 1 line 7 (random in-window entry is realised as
        closest-to-a-sampled-value).  Returns None when no value is in range.
        """
        if self.n == 0 or y < x:
            return None
        lo = self.rank(x)  # index of first value >= x
        hi = self.count_le(y) - 1  # index of last value <= y
        if hi < lo:
            return None
        # binary search by rank for the value closest to ``value``
        lo_i, hi_i = lo, hi
        while lo_i < hi_i:
            mid = (lo_i + hi_i) // 2
            if self.select(mid) < value:
                lo_i = mid + 1
            else:
                hi_i = mid
        cand = self.select(lo_i)
        if lo_i > lo:
            below = self.select(lo_i - 1)
            if abs(below - value) <= abs(cand - value):
                cand = below
        return float(cand)

    def in_order(self) -> np.ndarray:
        """All unique values in sorted order (testing/snapshots)."""
        out = np.empty(self.n, dtype=np.float64)
        stack: list[int] = []
        t = self.root
        i = 0
        while stack or t != _NIL:
            while t != _NIL:
                stack.append(t)
                t = int(self.left[t])
            t = stack.pop()
            out[i] = self.val[t]
            i += 1
            t = int(self.right[t])
        return out

    # --------------------------------------------------------------- validity
    def check_invariants(self) -> None:
        """Raise AssertionError unless BST order, sizes and balance hold."""
        if self.root == _NIL:
            assert self.n == 0
            return
        seen = 0
        stack: list[tuple[int, float, float]] = [(self.root, -np.inf, np.inf)]
        while stack:
            t, lo, hi = stack.pop()
            v = float(self.val[t])
            assert lo < v < hi, f"BST order violated at node {t}"
            l, r = int(self.left[t]), int(self.right[t])
            assert self.size[t] == 1 + self._sz(l) + self._sz(r), "bad size"
            wl, wr = self._sz(l) + 1, self._sz(r) + 1
            assert wl <= _DELTA * wr and wr <= _DELTA * wl, (
                f"balance violated at node {t}: {wl} vs {wr}"
            )
            seen += 1
            if l != _NIL:
                stack.append((l, lo, v))
            if r != _NIL:
                stack.append((r, v, hi))
        assert seen == self.n, "node count mismatch"
