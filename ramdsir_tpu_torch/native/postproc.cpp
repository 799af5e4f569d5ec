// Native post-processing and surface-distance kernels (the port's own copy
// of ramdsir_tpu/native/postproc.cpp, unchanged below this header).
//
// Replaces the Python/scipy host-side hot loops (the #3 hot path in the
// reference per SURVEY.md §3: medpy HD95/ASD on 800x800 fundus masks):
//   * largest_cc_fillhole  — 8-connected largest component + hole filling
//     (reference utils/utils.py:19-28 semantics).
//   * largest_cc_nd        — connectivity-1 largest component over an
//     arbitrary-rank volume (utils/utils.py:30-42 semantics, including the
//     "background wins on empty mask" argmax quirk).
//   * surface_distances    — directed border-to-border Euclidean distances
//     (medpy __surface_distances semantics): connectivity-1 borders, exact
//     squared EDT (Felzenszwalb–Huttenlocher), gathered at result-border
//     voxels.
//
// Pure C ABI for ctypes; no Python.h dependency.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <limits>
#include <algorithm>

extern "C" {

// ---------- connected components ----------

// 8-connected 2-D labeling in scan order; returns number of labels.
static int label_2d_8(const uint8_t* mask, int h, int w, std::vector<int>& labels) {
    labels.assign((size_t)h * w, 0);
    int next = 0;
    std::vector<int> stack;
    for (int i = 0; i < h * w; ++i) {
        if (!mask[i] || labels[i]) continue;
        ++next;
        stack.clear();
        stack.push_back(i);
        labels[i] = next;
        while (!stack.empty()) {
            int cur = stack.back();
            stack.pop_back();
            int y = cur / w, x = cur % w;
            for (int dy = -1; dy <= 1; ++dy) {
                for (int dx = -1; dx <= 1; ++dx) {
                    if (!dy && !dx) continue;
                    int ny = y + dy, nx = x + dx;
                    if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
                    int n = ny * w + nx;
                    if (mask[n] && !labels[n]) {
                        labels[n] = next;
                        stack.push_back(n);
                    }
                }
            }
        }
    }
    return next;
}

// Largest 8-connected CC (first max wins), then fill holes: background not
// reachable 4-connected from the border becomes foreground.
void largest_cc_fillhole(const uint8_t* mask, int h, int w, uint8_t* out) {
    std::vector<int> labels;
    int n = label_2d_8(mask, h, w, labels);
    std::memset(out, 0, (size_t)h * w);
    if (n == 0) return;
    std::vector<int64_t> sizes(n + 1, 0);
    for (int i = 0; i < h * w; ++i) sizes[labels[i]]++;
    sizes[0] = -1;
    int keep = 1;
    for (int l = 2; l <= n; ++l)
        if (sizes[l] > sizes[keep]) keep = l;

    // flood outside-background from borders, 4-connected
    std::vector<uint8_t> outside((size_t)h * w, 0);
    std::queue<int> q;
    auto push_bg = [&](int y, int x) {
        int i = y * w + x;
        if (labels[i] != keep && !outside[i]) {
            outside[i] = 1;
            q.push(i);
        }
    };
    for (int x = 0; x < w; ++x) { push_bg(0, x); push_bg(h - 1, x); }
    for (int y = 0; y < h; ++y) { push_bg(y, 0); push_bg(y, w - 1); }
    while (!q.empty()) {
        int cur = q.front(); q.pop();
        int y = cur / w, x = cur % w;
        const int dy[4] = {-1, 1, 0, 0}, dx[4] = {0, 0, -1, 1};
        for (int k = 0; k < 4; ++k) {
            int ny = y + dy[k], nx = x + dx[k];
            if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
            push_bg(ny, nx);
        }
    }
    for (int i = 0; i < h * w; ++i)
        out[i] = (labels[i] == keep || !outside[i]) ? 1 : 0;
}

// Connectivity-1 labeling over an nd volume given dims (rank<=4).
// Keeps the largest component by mask-weighted size including the
// background bucket (index 0, size 0): empty mask -> all zeros.
void largest_cc_nd(const uint8_t* mask, const int64_t* dims, int rank, uint8_t* out) {
    int64_t total = 1;
    for (int r = 0; r < rank; ++r) total *= dims[r];
    std::vector<int64_t> strides(rank, 1);
    for (int r = rank - 2; r >= 0; --r) strides[r] = strides[r + 1] * dims[r + 1];

    std::vector<int> labels((size_t)total, 0);
    std::vector<int64_t> coord(rank);
    std::vector<int64_t> stack;
    int next = 0;
    for (int64_t i = 0; i < total; ++i) {
        if (!mask[i] || labels[i]) continue;
        ++next;
        stack.clear();
        stack.push_back(i);
        labels[i] = next;
        while (!stack.empty()) {
            int64_t cur = stack.back();
            stack.pop_back();
            int64_t rem = cur;
            for (int r = 0; r < rank; ++r) { coord[r] = rem / strides[r]; rem %= strides[r]; }
            for (int r = 0; r < rank; ++r) {
                for (int d = -1; d <= 1; d += 2) {
                    int64_t c = coord[r] + d;
                    if (c < 0 || c >= dims[r]) continue;
                    int64_t n = cur + d * strides[r];
                    if (mask[n] && !labels[n]) {
                        labels[n] = next;
                        stack.push_back(n);
                    }
                }
            }
        }
    }
    std::vector<int64_t> sizes(next + 1, 0);
    for (int64_t i = 0; i < total; ++i) sizes[labels[i]] += mask[i] ? 1 : 0;
    int winner = 0;
    for (int l = 1; l <= next; ++l)
        if (sizes[l] > sizes[winner]) winner = l;
    if (winner == 0) { std::memset(out, 0, (size_t)total); return; }
    for (int64_t i = 0; i < total; ++i) out[i] = labels[i] == winner ? 1 : 0;
}

// ---------- exact Euclidean distance transform ----------

static void dt_1d(const double* f, int n, double* d, int* v, double* z) {
    // Felzenszwalb–Huttenlocher lower envelope of parabolas.
    int k = 0;
    v[0] = 0;
    z[0] = -std::numeric_limits<double>::infinity();
    z[1] = std::numeric_limits<double>::infinity();
    for (int q = 1; q < n; ++q) {
        if (f[q] == std::numeric_limits<double>::infinity()) continue;
        double s;
        while (true) {
            if (f[v[k]] == std::numeric_limits<double>::infinity()) {
                // degenerate: previous site at infinity — replace it
                if (k == 0) { v[0] = q; z[0] = -std::numeric_limits<double>::infinity(); z[1] = std::numeric_limits<double>::infinity(); break; }
                --k;
                continue;
            }
            s = ((f[q] + (double)q * q) - (f[v[k]] + (double)v[k] * v[k])) / (2.0 * q - 2.0 * v[k]);
            if (s <= z[k]) { --k; continue; }
            break;
        }
        if (v[k] != q) {
            ++k;
            v[k] = q;
            z[k] = s;
            z[k + 1] = std::numeric_limits<double>::infinity();
        }
    }
    k = 0;
    for (int q = 0; q < n; ++q) {
        while (z[k + 1] < q) ++k;
        double dq = (double)q - v[k];
        d[q] = dq * dq + f[v[k]];
    }
}

// squared EDT of "sites" (site=1 -> 0, else INF) over an nd grid.
static void edt_nd(const uint8_t* sites, const int64_t* dims, int rank, std::vector<double>& dist) {
    int64_t total = 1;
    for (int r = 0; r < rank; ++r) total *= dims[r];
    dist.assign((size_t)total, 0.0);
    const double INF = std::numeric_limits<double>::infinity();
    for (int64_t i = 0; i < total; ++i) dist[i] = sites[i] ? 0.0 : INF;

    std::vector<int64_t> strides(rank, 1);
    for (int r = rank - 2; r >= 0; --r) strides[r] = strides[r + 1] * dims[r + 1];

    int64_t maxdim = 0;
    for (int r = 0; r < rank; ++r) maxdim = std::max(maxdim, dims[r]);
    std::vector<double> f(maxdim), d(maxdim), z(maxdim + 1);
    std::vector<int> v(maxdim);

    for (int axis = 0; axis < rank; ++axis) {
        int64_t n = dims[axis], stride = strides[axis];
        int64_t lines = total / n;
        for (int64_t line = 0; line < lines; ++line) {
            // base index of this line: expand line over the other axes
            int64_t base = 0, rem = line;
            for (int r = rank - 1; r >= 0; --r) {
                if (r == axis) continue;
                int64_t c = rem % dims[r];
                rem /= dims[r];
                base += c * strides[r];
            }
            bool all_inf = true;
            for (int64_t i = 0; i < n; ++i) {
                f[i] = dist[base + i * stride];
                if (f[i] != INF) all_inf = false;
            }
            if (all_inf) continue;
            dt_1d(f.data(), (int)n, d.data(), v.data(), z.data());
            for (int64_t i = 0; i < n; ++i) dist[base + i * stride] = d[i];
        }
    }
}

// connectivity-1 border: mask minus erosion (border_value=0 at edges).
static void border_nd(const uint8_t* mask, const int64_t* dims, int rank, std::vector<uint8_t>& border) {
    int64_t total = 1;
    for (int r = 0; r < rank; ++r) total *= dims[r];
    std::vector<int64_t> strides(rank, 1);
    for (int r = rank - 2; r >= 0; --r) strides[r] = strides[r + 1] * dims[r + 1];
    border.assign((size_t)total, 0);
    std::vector<int64_t> coord(rank);
    for (int64_t i = 0; i < total; ++i) {
        if (!mask[i]) continue;
        int64_t rem = i;
        bool eroded = true;
        for (int r = 0; r < rank; ++r) { coord[r] = rem / strides[r]; rem %= strides[r]; }
        for (int r = 0; r < rank && eroded; ++r) {
            for (int d = -1; d <= 1 && eroded; d += 2) {
                int64_t c = coord[r] + d;
                if (c < 0 || c >= dims[r]) { eroded = false; break; }  // border_value=0
                if (!mask[i + d * strides[r]]) eroded = false;
            }
        }
        border[i] = eroded ? 0 : 1;
    }
}

// Directed surface distances result->reference.  Writes up to `cap`
// distances into out; returns the number of result-border voxels
// (negative on error: -1 empty result, -2 empty reference).
int64_t surface_distances(
    const uint8_t* result, const uint8_t* reference,
    const int64_t* dims, int rank, double* out, int64_t cap) {
    int64_t total = 1;
    for (int r = 0; r < rank; ++r) total *= dims[r];
    bool any_r = false, any_g = false;
    for (int64_t i = 0; i < total && !(any_r && any_g); ++i) {
        any_r |= result[i] != 0;
        any_g |= reference[i] != 0;
    }
    if (!any_r) return -1;
    if (!any_g) return -2;

    std::vector<uint8_t> rb, gb;
    border_nd(result, dims, rank, rb);
    border_nd(reference, dims, rank, gb);
    std::vector<double> dist;
    edt_nd(gb.data(), dims, rank, dist);

    int64_t count = 0;
    for (int64_t i = 0; i < total; ++i) {
        if (!rb[i]) continue;
        if (count < cap) out[count] = std::sqrt(dist[i]);
        ++count;
    }
    return count;
}

}  // extern "C"
