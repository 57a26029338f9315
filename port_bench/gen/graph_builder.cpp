// The benchmark's frozen copy of the port's native graph builder
// (babble_tpu_torch/native/graph_builder.cpp): bulk random-gossip DAG
// generation, level assignment and level-schedule construction.  The
// benchmark keeps its own copy so that the traffic it generates cannot
// change with the program; gen/gossip.py builds it with g++ into
// port_bench/_build/ and pins its output to a digest (test_port_bench.py).
//
// Gossip shape per the reference's node/node.go:193-222: each step one
// receiver syncs from one random sender and mints an event with parents
// (own head, sender head).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

static inline uint64_t splitmix64(uint64_t *state) {
    uint64_t z = (*state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

// Fills the struct-of-arrays DAG.  Arrays are caller-allocated with
// n_events entries.  Returns the number of distinct levels.
long gossip_dag(
    uint64_t seed, int32_t n, int64_t n_events,
    int64_t ts_granularity_ns, int64_t base_ts,
    int32_t *sp, int32_t *op, int32_t *creator, int32_t *seq,
    int64_t *ts, uint8_t *mbit, int32_t *levels, int32_t *heads /* [n] */
) {
    uint64_t st = seed * 2ULL + 1ULL;
    int64_t k = 0;
    int32_t max_level = 0;
    for (int32_t i = 0; i < n && k < n_events; ++i, ++k) {
        sp[k] = -1; op[k] = -1; creator[k] = i; seq[k] = 0;
        ts[k] = base_ts; levels[k] = 0;
        mbit[k] = (uint8_t)(splitmix64(&st) & 1ULL);
        heads[i] = (int32_t)k;
    }
    // per-creator next sequence number lives in a scratch vector
    int32_t *seqs = new int32_t[n];
    for (int32_t i = 0; i < n; ++i) seqs[i] = 1;

    for (int64_t t = 1; k < n_events; ++t, ++k) {
        int32_t r = (int32_t)(splitmix64(&st) % (uint64_t)n);
        int32_t s = (int32_t)(splitmix64(&st) % (uint64_t)(n - 1));
        if (s >= r) s += 1;
        int64_t raw = t * 1987963LL;
        ts[k] = base_ts + (raw / ts_granularity_ns) * ts_granularity_ns;
        int32_t sps = heads[r], opsl = heads[s];
        sp[k] = sps; op[k] = opsl;
        creator[k] = r; seq[k] = seqs[r]++;
        int32_t lvl = 1 + std::max(levels[sps], levels[opsl]);
        levels[k] = lvl;
        if (lvl > max_level) max_level = lvl;
        mbit[k] = (uint8_t)(splitmix64(&st) & 1ULL);
        heads[r] = (int32_t)k;
    }
    delete[] seqs;
    return (long)(max_level + 1);
}

// Level-schedule construction: group event indices [0, k) by level into a
// row-per-level table of width `width`, padded with -1.  Events within a
// level keep ascending order (stable).  Returns 0, or -1 if any level
// exceeds `width` (caller re-allocates using level_counts).
int32_t build_schedule(
    const int32_t *levels, int64_t k, int32_t n_levels, int32_t width,
    int32_t *sched /* [n_levels * width] */, int32_t *fill /* [n_levels] */
) {
    memset(fill, 0, sizeof(int32_t) * (size_t)n_levels);
    for (int64_t i = 0; i < (int64_t)n_levels * width; ++i) sched[i] = -1;
    for (int64_t i = 0; i < k; ++i) {
        int32_t l = levels[i];
        if (l < 0 || l >= n_levels) return -1;
        int32_t pos = fill[l]++;
        if (pos >= width) return -1;
        sched[(int64_t)l * width + pos] = (int32_t)i;
    }
    return 0;
}

// Per-level counts (to size the schedule width before building it).
int32_t max_level_width(const int32_t *levels, int64_t k, int32_t n_levels,
                        int32_t *counts /* [n_levels] */) {
    memset(counts, 0, sizeof(int32_t) * (size_t)n_levels);
    int32_t mx = 0;
    for (int64_t i = 0; i < k; ++i) {
        int32_t c = ++counts[levels[i]];
        if (c > mx) mx = c;
    }
    return mx;
}

}  // extern "C"
