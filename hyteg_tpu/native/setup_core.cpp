// Native setup core: host-side hot paths of the mesh runtime.
//
// Counterpart of the reference's native (C++) setup
// infrastructure (reference: src/hyteg/primitivestorage/ and the waLBerla
// core the reference builds on). The compute path is JAX/XLA;
// this library accelerates the *setup* paths that run on the host per
// storage construction / re-balance: space-filling-curve encoding, sorting
// and weighted partitioning over macro-cells. Exposed via a C ABI and
// loaded with ctypes (no pybind11 in the image); every entry point has a
// numpy fallback in hyteg_tpu/native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Morton (Z-order) codes of n points in R^dim, normalized to the bounding
// box, `bits` bits per axis. pts is row-major (n, dim).
void ht_morton_codes(const double* pts, int64_t n, int32_t dim, int32_t bits,
                     uint64_t* out) {
    if (n <= 0) return;
    std::vector<double> lo(dim, 1e300), hi(dim, -1e300);
    for (int64_t i = 0; i < n; ++i)
        for (int32_t d = 0; d < dim; ++d) {
            double v = pts[i * dim + d];
            lo[d] = std::min(lo[d], v);
            hi[d] = std::max(hi[d], v);
        }
    const uint64_t maxq = (bits >= 64) ? ~0ull : ((1ull << bits) - 1ull);
    for (int64_t i = 0; i < n; ++i) {
        uint64_t code = 0;
        for (int32_t d = 0; d < dim; ++d) {
            double span = hi[d] - lo[d];
            double t = span == 0.0 ? 0.0 : (pts[i * dim + d] - lo[d]) / span;
            uint64_t q = (uint64_t)(t * (double)maxq);
            for (int32_t b = 0; b < bits; ++b)
                code |= ((q >> b) & 1ull) << (uint64_t)(b * dim + d);
        }
        out[i] = code;
    }
}

// Stable argsort of uint64 keys.
void ht_argsort_u64(const uint64_t* keys, int64_t n, int64_t* order) {
    std::iota(order, order + n, (int64_t)0);
    std::stable_sort(order, order + n, [keys](int64_t a, int64_t b) {
        return keys[a] < keys[b];
    });
}

// Greedy weighted partition: heaviest cell to lightest shard, never leaving
// a shard empty (reference: loadbalancing::greedy).
void ht_greedy_partition(const double* w, int64_t n, int32_t shards,
                         int64_t* assignment) {
    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), (int64_t)0);
    std::stable_sort(order.begin(), order.end(),
                     [w](int64_t a, int64_t b) { return w[a] > w[b]; });
    std::vector<double> loads(shards, 0.0);
    std::vector<int64_t> counts(shards, 0);
    for (int64_t i = 0; i < n; ++i) {
        int64_t remaining = n - i;
        int64_t empties = 0;
        for (int32_t d = 0; d < shards; ++d) empties += (counts[d] == 0);
        int32_t pick;
        if (empties > 0 && remaining <= empties) {
            pick = 0;
            while (counts[pick] != 0) ++pick;
        } else {
            pick = (int32_t)(std::min_element(loads.begin(), loads.end()) -
                             loads.begin());
        }
        assignment[order[i]] = pick;
        loads[pick] += w[order[i]];
        counts[pick] += 1;
    }
}

// Canonical (sorted) key of k-tuples of int64 vertex ids -> 3 packed sorted
// columns; used for sub-simplex (edge/face) deduplication in the storage
// setup. rows: (n, k) row-major; out: (n, k) sorted per row.
void ht_sort_rows_i64(const int64_t* rows, int64_t n, int32_t k,
                      int64_t* out) {
    std::vector<int64_t> buf(k);
    for (int64_t i = 0; i < n; ++i) {
        for (int32_t j = 0; j < k; ++j) buf[j] = rows[i * k + j];
        std::sort(buf.begin(), buf.end());
        for (int32_t j = 0; j < k; ++j) out[i * k + j] = buf[j];
    }
}

}  // extern "C"
