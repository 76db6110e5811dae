// Hungarian (Kuhn-Munkres) assignment solver, O(n^3).
//
// The port's own copy of the JAX package's native solver, line for line in
// its arithmetic and its scan order, so that both give the same assignment,
// ties included. The MCC metric solves one assignment per evaluation; the
// Python solver (evaluation/munkres.py) takes n < 20 and this one n >= 20,
// where the interpreted matrix algorithm grows slow. It is the shortest-
// augmenting-path (Jonker-Volgenant style) formulation with potentials, a
// minimum-cost perfect matching: the optimal cost of the classic 6-step
// matrix algorithm.
//
// C ABI for ctypes:
//   hungarian_solve(cost, n, row_to_col) — cost is row-major n*n doubles,
//   row_to_col receives the assigned column for each row.
//
// Built by native/build.py with the loader into one shared library.

#include <vector>
#include <limits>
#include <cstdint>

extern "C" {

void hungarian_solve(const double* cost, int n, int* row_to_col) {
    const double INF = std::numeric_limits<double>::infinity();
    // potentials over rows (u) and columns (v); way[j] = augmenting-path
    // parent of column j; p[j] = row matched to column j (1-indexed).
    std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
    std::vector<int> p(n + 1, 0), way(n + 1, 0);

    for (int i = 1; i <= n; ++i) {
        p[0] = i;
        int j0 = 0;
        std::vector<double> minv(n + 1, INF);
        std::vector<char> used(n + 1, false);
        do {
            used[j0] = true;
            int i0 = p[j0], j1 = 0;
            double delta = INF;
            for (int j = 1; j <= n; ++j) {
                if (used[j]) continue;
                double cur = cost[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
                if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
                if (minv[j] < delta) { delta = minv[j]; j1 = j; }
            }
            for (int j = 0; j <= n; ++j) {
                if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
                else { minv[j] -= delta; }
            }
            j0 = j1;
        } while (p[j0] != 0);
        // augment along the path
        do {
            int j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0);
    }
    for (int j = 1; j <= n; ++j) {
        if (p[j] > 0) row_to_col[p[j] - 1] = j - 1;
    }
}

}  // extern "C"
