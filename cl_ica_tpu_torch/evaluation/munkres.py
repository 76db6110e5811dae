"""Hungarian (Kuhn-Munkres) assignment solver.

The port's own copy of cl_ica_tpu/evaluation/munkres.py: the classic
6-step matrix algorithm (Munkres 1957) with numpy-vectorized steps, and for
n >= 20 the C++ solver of the port's native library (native/hungarian.cpp),
as the JAX package routes them. For MCC matrices (n ≈ 10) the Python
solver runs host-side in microseconds. A native route that cannot build
raises; it never falls back to the Python solver.

Any optimal assignment yields the same total cost, so MCC scores do not
depend on tie-breaking; the Python steps scan rows/cols in ascending index
order, and the C++ solver is the JAX package's line for line.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..native import hungarian_solve_native


def hungarian(cost: np.ndarray, prefer_native: bool = None) -> List[Tuple[int, int]]:
    """Minimum-cost assignment of rows to columns.

    Returns [(row, col), ...] sorted by row, one entry per row of the
    (possibly rectangular) cost matrix after zero-padding to square.

    prefer_native: route through the C++ solver. Default: only for n >= 20,
    as in the JAX package — both solvers return an optimal matching, but
    tie-breaking can differ, so small n stays on the Python solver.
    """
    cost = np.asarray(cost, dtype=np.float64)
    orig_rows, orig_cols = cost.shape
    n = max(orig_rows, orig_cols)
    c = np.zeros((n, n), dtype=np.float64)
    c[:orig_rows, :orig_cols] = cost

    if prefer_native is None:
        prefer_native = n >= 20
    if prefer_native:
        row_to_col = hungarian_solve_native(c)
        return [(i, int(row_to_col[i])) for i in range(n)]

    starred = np.zeros((n, n), dtype=bool)
    primed = np.zeros((n, n), dtype=bool)
    row_covered = np.zeros(n, dtype=bool)
    col_covered = np.zeros(n, dtype=bool)

    # Step 1: subtract row minima.
    c -= c.min(axis=1, keepdims=True)

    # Step 2: star zeros with no starred zero in their row/col.
    for i in range(n):
        for j in range(n):
            if c[i, j] == 0 and not row_covered[i] and not col_covered[j]:
                starred[i, j] = True
                row_covered[i] = True
                col_covered[j] = True
    row_covered[:] = False
    col_covered[:] = False

    while True:
        # Step 3: cover columns containing starred zeros.
        col_covered = starred.any(axis=0)
        if col_covered.sum() >= n:
            break

        # Steps 4-6 inner loop.
        while True:
            # Step 4: find an uncovered zero and prime it.
            zero = _find_uncovered_zero(c, row_covered, col_covered)
            if zero is None:
                # Step 6: adjust matrix by the smallest uncovered value.
                uncovered = ~row_covered[:, None] & ~col_covered[None, :]
                minval = c[uncovered].min()
                c[row_covered, :] += minval
                c[:, ~col_covered] -= minval
                continue
            i, j = zero
            primed[i, j] = True
            star_col = np.flatnonzero(starred[i])
            if star_col.size:
                # Cover this row, uncover the starred zero's column.
                row_covered[i] = True
                col_covered[star_col[0]] = False
            else:
                # Step 5: augmenting path of alternating primes/stars.
                _augment(starred, primed, i, j)
                row_covered[:] = False
                col_covered[:] = False
                primed[:] = False
                break

    rows, cols = np.nonzero(starred)
    order = np.argsort(rows)
    return [(int(r), int(cl)) for r, cl in zip(rows[order], cols[order])]


def _find_uncovered_zero(c, row_covered, col_covered):
    mask = (c == 0) & ~row_covered[:, None] & ~col_covered[None, :]
    idx = np.argwhere(mask)
    if idx.size == 0:
        return None
    return int(idx[0, 0]), int(idx[0, 1])


def _augment(starred, primed, i, j):
    """Flip the alternating prime/star path starting at primed (i, j)."""
    path = [(i, j)]
    while True:
        r = np.flatnonzero(starred[:, path[-1][1]])
        if r.size == 0:
            break
        path.append((int(r[0]), path[-1][1]))
        cl = np.flatnonzero(primed[path[-1][0]])
        path.append((path[-1][0], int(cl[0])))
    for r, cl in path:
        starred[r, cl] = not starred[r, cl]


class Munkres:
    """The solver behind a ``compute``/``pad_matrix`` object interface."""

    def compute(self, cost_matrix) -> List[Tuple[int, int]]:
        return hungarian(np.asarray(cost_matrix))

    def pad_matrix(self, matrix: Sequence[Sequence[float]], pad_value: float = 0):
        matrix = [list(row) for row in matrix]
        max_columns = max(len(row) for row in matrix)
        total_rows = max(max_columns, len(matrix))
        new_matrix = []
        for row in matrix:
            new_matrix.append(row + [pad_value] * (total_rows - len(row)))
        while len(new_matrix) < total_rows:
            new_matrix.append([pad_value] * total_rows)
        return new_matrix
