// Reference-algorithm consensus baseline in C++.
//
// PURPOSE: an honest, same-machine, compute-bound stand-in for the Go
// reference's consensus pipeline (BenchmarkFindOrder scaled up,
// reference hashgraph/hashgraph_test.go:1049-1060).  BASELINE.md requires
// the ">=100x the Go inmem baseline" claim to be measured against the
// reference *algorithm* on this machine, not the 2017 Docker-testnet
// wall-clock figure; no Go toolchain exists in this image, so the
// algorithm is re-implemented here with the same asymptotics and data
// structures a performant Go version uses (per-event coordinate vectors,
// memoized strongly-see, incremental first-descendant backprop).  C++ vs
// Go on this pointer/array-walk workload is within a small constant, and
// the constant favors the baseline — which makes vs_baseline conservative.
//
// Semantics mirror consensus/oracle.py (itself the documented faithful
// port of hashgraph/hashgraph.go):
//   insert (InitEventCoordinates + UpdateAncestorFirstDescendant)
//     hashgraph.go:399-494
//   DivideRounds (ParentRound/RoundInc/Witness)     hashgraph.go:211-305,573
//   DecideFame (virtual voting + coin rounds)       hashgraph.go:590-673
//   DecideRoundReceived + median timestamps         hashgraph.go:676-721
// Differentially tested against the TPU engine (tests/test_arrays.py).
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py; no external deps).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <unordered_map>

namespace {

constexpr int32_t I32_MAX = INT32_MAX;

struct Baseline {
    int32_t n;
    int64_t e;
    const int32_t *sp, *op, *creator, *seq;
    const int64_t *ts;
    const uint8_t *mbit;

    std::vector<int32_t> la;   // [E, N] last-ancestor seq, -1 = none
    std::vector<int32_t> fd;   // [E, N] first-descendant seq, I32_MAX = none
    std::vector<std::vector<int32_t>> chains;       // creator -> slots by seq
    std::vector<std::vector<int32_t>> witnesses;    // round -> witness slots
    std::vector<int32_t> round;
    std::vector<uint8_t> witness;
    std::vector<int8_t> fame;  // per event: -1 not witness, 0 undec, 1 T, 2 F
    std::vector<int32_t> rr;
    std::vector<int64_t> cts;
    int32_t super_majority;

    Baseline(int32_t n_, int64_t e_, const int32_t *sp_, const int32_t *op_,
             const int32_t *creator_, const int32_t *seq_, const int64_t *ts_,
             const uint8_t *mbit_)
        : n(n_), e(e_), sp(sp_), op(op_), creator(creator_), seq(seq_),
          ts(ts_), mbit(mbit_),
          la((size_t)e_ * n_, -1), fd((size_t)e_ * n_, I32_MAX),
          chains(n_), round(e_, -1), witness(e_, 0), fame(e_, -1),
          rr(e_, -1), cts(e_, 0),
          super_majority(2 * n_ / 3 + 1) {}

    inline int32_t *la_row(int64_t x) { return &la[(size_t)x * n]; }
    inline int32_t *fd_row(int64_t x) { return &fd[(size_t)x * n]; }

    // see(w, x): x is an ancestor of w (hashgraph.go:92-114;
    // fork-free See == Ancestor, hashgraph.go:148-154)
    inline bool sees(int64_t w, int64_t x) {
        return la_row(w)[creator[x]] >= seq[x];
    }

    // strongly_see(x, y) (hashgraph.go:189-208)
    inline bool strongly_sees(int64_t x, int64_t y) {
        const int32_t *lax = la_row(x), *fdy = fd_row(y);
        int32_t c = 0;
        for (int32_t k = 0; k < n; ++k) c += (lax[k] >= fdy[k]);
        return c >= super_majority;
    }

    // insert + coordinates, events arrive in topological order
    void insert(int64_t x) {
        int32_t c = creator[x];
        int32_t *row = la_row(x);
        if (sp[x] >= 0) {
            const int32_t *ps = la_row(sp[x]);
            std::memcpy(row, ps, sizeof(int32_t) * n);
            if (op[x] >= 0) {
                const int32_t *po = la_row(op[x]);
                for (int32_t k = 0; k < n; ++k)
                    row[k] = std::max(row[k], po[k]);
            }
        } else if (op[x] >= 0) {
            std::memcpy(row, la_row(op[x]), sizeof(int32_t) * n);
        }
        row[c] = seq[x];
        fd_row(x)[c] = seq[x];
        if ((int32_t)chains[c].size() != seq[x]) return;  // defensive
        chains[c].push_back((int32_t)x);

        // UpdateAncestorFirstDescendant (hashgraph.go:466-494): walk each
        // last-ancestor's self-chain until a link already has a first
        // descendant by this creator
        for (int32_t k = 0; k < n; ++k) {
            int32_t s = row[k];
            while (s >= 0) {
                int64_t a = chains[k][s];
                if (fd_row(a)[c] == I32_MAX) {
                    fd_row(a)[c] = seq[x];
                    --s;
                } else {
                    break;
                }
            }
        }
    }

    // DivideRounds: round/witness assignment in topological order
    void divide_rounds(int64_t x) {
        int32_t pr;  // ParentRound (hashgraph.go:211-241)
        if (sp[x] < 0 && op[x] < 0) {
            pr = 0;
        } else if (sp[x] < 0 || op[x] < 0) {
            pr = 0;  // oracle: missing either parent -> 0
        } else {
            pr = std::max(round[sp[x]], round[op[x]]);
        }
        bool inc = false;  // RoundInc (hashgraph.go:263-284)
        if (pr >= 0 && pr < (int32_t)witnesses.size()) {
            int32_t cnt = 0;
            for (int32_t w : witnesses[pr])
                if (strongly_sees(x, w)) ++cnt;
            inc = cnt >= super_majority;
        }
        int32_t r = (sp[x] < 0 && op[x] < 0) ? 0 : pr + (inc ? 1 : 0);
        round[x] = r;
        bool wit = sp[x] < 0 || r > round[sp[x]];
        witness[x] = wit;
        if (wit) {
            if ((int32_t)witnesses.size() <= r) witnesses.resize(r + 1);
            witnesses[r].push_back((int32_t)x);
            fame[x] = 0;
        }
    }

    // DecideFame (hashgraph.go:590-673), sticky decisions as in oracle.py
    void decide_fame() {
        int32_t R = (int32_t)witnesses.size();
        // votes keyed on the packed (y, x) witness-slot pair
        std::unordered_map<int64_t, bool> votes;
        auto vkey = [](int64_t y, int64_t x) { return (y << 32) | x; };
        // memoized strongly-seen witness lists: y -> witnesses of round[y]-1
        std::unordered_map<int64_t, std::vector<int32_t>> ss_memo;

        for (int32_t i = 0; i + 1 < R; ++i) {
            for (int32_t j = i + 1; j < R; ++j) {
                for (int32_t x : witnesses[i]) {
                    if (fame[x] != 0) continue;  // sticky
                    for (int32_t y : witnesses[j]) {
                        int32_t diff = j - i;
                        if (diff == 1) {
                            votes[vkey(y, x)] = sees(y, x);
                            continue;
                        }
                        auto it = ss_memo.find(y);
                        if (it == ss_memo.end()) {
                            std::vector<int32_t> ss;
                            for (int32_t w : witnesses[j - 1])
                                if (strongly_sees(y, w)) ss.push_back(w);
                            it = ss_memo.emplace(y, std::move(ss)).first;
                        }
                        int32_t yays = 0;
                        for (int32_t w : it->second) {
                            auto v = votes.find(vkey(w, x));
                            if (v != votes.end() && v->second) ++yays;
                        }
                        int32_t nays = (int32_t)it->second.size() - yays;
                        bool v = yays >= nays;
                        int32_t t = v ? yays : nays;
                        if (diff % n > 0) {  // normal round
                            if (t >= super_majority) {
                                fame[x] = v ? 1 : 2;
                                break;  // next x
                            }
                            votes[vkey(y, x)] = v;
                        } else {             // coin round
                            if (t >= super_majority)
                                votes[vkey(y, x)] = v;
                            else
                                votes[vkey(y, x)] = mbit[y] != 0;
                        }
                    }
                }
            }
        }
    }

    // DecideRoundReceived + median consensus timestamps
    // (hashgraph.go:676-721, 762-770)
    void decide_order() {
        int32_t R = (int32_t)witnesses.size();
        std::vector<uint8_t> decided(R, 0);
        std::vector<std::vector<int32_t>> famous(R);
        for (int32_t r = 0; r < R; ++r) {
            bool all = true;
            for (int32_t w : witnesses[r]) {
                if (fame[w] == 0) all = false;
                else if (fame[w] == 1) famous[r].push_back(w);
            }
            decided[r] = all && !witnesses[r].empty();
        }
        std::vector<int64_t> med;
        for (int64_t x = 0; x < e; ++x) {
            for (int32_t i = round[x] + 1; i < R; ++i) {
                if (!decided[i]) continue;  // skip, not break
                med.clear();
                for (int32_t w : famous[i])
                    if (sees(w, x)) {
                        // oldest self-ancestor of w to see x
                        // (hashgraph.go:166-177): creator(w)'s chain event
                        // at seq fd[x, creator(w)]
                        int32_t cw = creator[w];
                        med.push_back(ts[chains[cw][fd_row(x)[cw]]]);
                    }
                if ((int32_t)med.size() * 2 > (int32_t)famous[i].size()) {
                    rr[x] = i;
                    std::sort(med.begin(), med.end());
                    cts[x] = med[med.size() / 2];
                    break;
                }
            }
        }
    }

    int64_t run() {
        for (int64_t x = 0; x < e; ++x) insert(x);
        for (int64_t x = 0; x < e; ++x) divide_rounds(x);
        decide_fame();
        decide_order();
        int64_t ordered = 0;
        for (int64_t x = 0; x < e; ++x) ordered += (rr[x] >= 0);
        return ordered;
    }
};

}  // namespace

extern "C" {

// Runs the full reference consensus pipeline over a topologically-ordered
// struct-of-arrays DAG.  Outputs are caller-allocated [e] arrays.
// Returns the number of events brought to consensus order, or -1 on error.
int64_t baseline_consensus(
    int32_t n, int64_t e,
    const int32_t *sp, const int32_t *op, const int32_t *creator,
    const int32_t *seq, const int64_t *ts, const uint8_t *mbit,
    int32_t *round_out, uint8_t *witness_out, int32_t *rr_out,
    int64_t *cts_out, int8_t *fame_out
) {
    if (n <= 0 || e <= 0) return -1;
    Baseline b(n, e, sp, op, creator, seq, ts, mbit);
    int64_t ordered = b.run();
    std::memcpy(round_out, b.round.data(), sizeof(int32_t) * e);
    std::memcpy(witness_out, b.witness.data(), sizeof(uint8_t) * e);
    std::memcpy(rr_out, b.rr.data(), sizeof(int32_t) * e);
    std::memcpy(cts_out, b.cts.data(), sizeof(int64_t) * e);
    std::memcpy(fame_out, b.fame.data(), sizeof(int8_t) * e);
    return ordered;
}

}  // extern "C"
