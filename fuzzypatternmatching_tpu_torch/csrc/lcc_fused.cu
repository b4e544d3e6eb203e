// Hand-written Hopper (sm_90a) kernels for the default-mode bucketed LCC
// superstep, each one launch a superstep over every ELL bucket:
//
//   * K1, init_superstep: the global init superstep. It replaces the
//     XLA-fused init superstep of the JAX package
//     (fuzzypatternmatching_tpu/engine/lcc_bucketed.py, _superstep :529-767
//     with init=True, called from _call_init1_seg :782-811): label-code
//     replay :593-602, acceptance and row OR, the split-hub segment OR
//     (K3, _segment_or :520, at :640/:665), the keep mask :656/:670, the
//     init gate and died :702-707, the alive update :710-715 and the
//     per-rank counters :724-741.
//   * K2, continuation_superstep: a non-init superstep, the same lines with
//     init=False, whose gather is gather_accept_or (_gather_accept_kernel,
//     fuzzypatternmatching_tpu/ops/lcc_superstep.py:105, called at
//     lcc_bucketed.py:604-620), followed by the same epilogue with the
//     continuation's rules.
//
//   * the counting instantiations of both (kCounting; entry points
//     fpm_init_superstep_counting, fpm_continuation_superstep_counting):
//     the upstream's --counting rule of the JAX package's _superstep
//     (:671-700, the counting branch's class counts), where candidate i
//     keeps its bit only if it heard required[i, j] accepted senders of
//     each label class j. They read a per-slot sender class byte (cls,
//     0 = none, 1..L) beside the other inputs and count, per segment, the
//     accepted slots of class j whose candidates meet adj_all[i], for
//     each requirement (i, j); the count mask is ANDed into the new tv
//     before the live test, the died test and the alive write.
//
// Bound on this card: bytes. tools_torch/common.superstep_bytes counts what
// each superstep must move, each input read once and each output written
// once: at R-MAT s21 (90.8 M slots, 2 M vertices) 310,941,830 B for the
// init superstep (0.093 ms at 3.35 TB/s): a 1-byte label code per slot
// read, a 1-byte alive flag per slot written, the tv planes; and for a
// continuation the state and rev and adj in full (0.34 ms). The kernels
// do no tensor-core work and nothing here needs more than integer
// arithmetic on a few registers per slot.
//
// What the design does about the bound: the eager superstep made about 450
// launches, each writing an intermediate plane ([n, w] candidates, accept
// flags, masks, [n, 16] bit planes) and reading it back. Here a slot's
// candidates, accept test and alive update live in registers; the only
// per-slot traffic is the streamed input bytes (the code, or the alive_rev,
// alive and tp_flag bytes of K2, 8 slots a lane as 8-byte loads) and the
// 1-byte output. K2 reads adj and the tv entry only where alive_rev is set
// (after the init superstep, well under 1 % of the slots), as the gather of
// csrc/lcc_superstep.cu does.
//
// Work split: the unit is a segment, a vertex's run of consecutive slots
// (one row; several rows for a split hub). One launch walks a task list
// over every bucket, the heaviest buckets' tasks first, in a grid-stride
// loop of 256-thread blocks:
//
//   * warp mode (widths 8..256 with 8-byte access, and widths 1..32): a
//     segment takes L lanes of a warp (L = w/8 lanes of 8 slots, or w lanes
//     of 1), a warp 32/L segments; the lanes meet in an xor-shuffle
//     reduction, every lane of the segment then knows its tn and new tv,
//     and writes its slots' alive flags once, from the accept bits it kept
//     in a register.
//   * block mode (wider rows, split hubs, anything else): a segment takes P
//     of the block's 8 warps (P = 8 for a split bucket, else about w/256):
//     its lanes stride over the segment's slot range, two steps' loads in
//     flight at a time, writing the alive value before the live test (a
//     hub's segment is one block's loop, so its latency is the kernel's
//     tail; the heaviest buckets' tasks start first), the OR and the
//     counts meet through
//     __reduce_or_sync / __reduce_add_sync and shared memory, and where the
//     segment dies, each lane that wrote a set flag clears its own slots
//     again (its own earlier stores, so no ordering across threads is
//     needed). The segment step needs no second pass over the slots.
//
// Counting: the requirements with required[i, j] > 0 form a list of
// pairs (at most 16 x 16), counted 16 pairs a register group: two words of
// 4-bit counts that saturate at 15 (no requirement is larger: the largest
// template degree), so a slot adds to them, and lanes meet them, by a
// saturating nibble add. Lanes meet a group as they meet tn and the
// counters: the xor-shuffle in warp mode; in block mode __reduce_add_sync
// over 16-bit fields, then shared memory across the segment's warps. The
// first group is counted in the superstep's own pass; a template with more
// than 16 requirements takes one more counting pass over the segment's
// slots a further group (only the reads, no write). K1 streams cls beside
// the codes; K2 reads it only where alive_rev is set, as it reads adj and
// tv. Nothing is written per slot but the alive byte.
//
// Counters: with one output rank each thread keeps its sums in registers
// and a warp reduction and one shared-memory atomic per warp follow at the
// end; with more ranks (up to kSharedRanks) each segment adds to per-rank
// partials in shared memory; either way each block then adds its partials
// to the int64 stats vector with one atomicAdd per nonzero entry. Integer
// sums: the result does not depend on their order. Past kSharedRanks ranks
// a segment adds to the stats vector directly. died is a flag: any dying
// segment stores 1.
//
// Plain C entry points (bound with ctypes): each launches on the stream it
// is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported to the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Buckets one launch takes; ops/lcc_fused.py (MAX_BUCKETS) checks the same.
constexpr int kMaxBuckets = 32;
constexpr int kMaxK = 16;  // template vertices: tv holds 16 bits
// Output ranks whose per-block partials live in shared memory.
constexpr int kSharedRanks = 1024;
// uint8 label codes: the code -> candidates table staged in shared memory.
constexpr int kSharedCodes = 256;
// Counting: label classes, requirement pairs a register group, all pairs.
constexpr int kMaxClasses = 16;
constexpr int kGroupPairs = 16;
constexpr int kMaxPairs = kMaxK * kMaxClasses;

int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 132;
    }
    return sms;
}

bool aligned(const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

struct Tmpl {
    int32_t k;
    uint32_t adj_all[kMaxK];
    uint32_t mand[kMaxK];
    uint32_t opt[kMaxK];
    int32_t opt_min[kMaxK];
};

// The counting rule: the sender's label class per slot, and one word a
// requirement pair, adj_all[i] (bits 0-15) | (j: class - 1) << 16 | i << 20
// | required[i, j] << 24, in groups of kGroupPairs; words past the last
// pair are 0 (they never count and are always met). The default mode's
// kernels take an empty NoReq in its place, so their Planes and code stay
// as they are.
struct Req {
    const uint8_t* cls;
    int32_t groups;  // 1 .. kMaxPairs / kGroupPairs
    uint32_t pair[kMaxPairs];
};
struct NoReq {};
template <bool kCounting> struct ReqOf { using type = NoReq; };
template <> struct ReqOf<true> { using type = Req; };
template <bool kCounting> using ReqT = typename ReqOf<kCounting>::type;

struct Buckets {
    int32_t count;
    int32_t width[kMaxBuckets];
    int32_t warp_mode[kMaxBuckets];  // 1: L lanes a segment in a warp; 0: P warps a segment
    int32_t vec[kMaxBuckets];        // slots a lane takes a step: 8 or 1
    int32_t group[kMaxBuckets];      // L (warp mode) or P (block mode)
    int32_t per_task[kMaxBuckets];   // segments a block task
    int32_t split[kMaxBuckets];
    int32_t order[kMaxBuckets];      // the bucket of the i-th task range
    int64_t n_seg[kMaxBuckets];
    int64_t slot_base[kMaxBuckets];
    int64_t seg_base[kMaxBuckets];
    int64_t start_base[kMaxBuckets];  // split buckets: their row starts in seg_start
    int64_t task_end[kMaxBuckets];    // running sum of the tasks, in `order`
};

struct Planes {
    const int32_t* adj;        // K2: neighbour id per slot (V at pads)
    const uint8_t* code8;      // K1: label code per slot, uint8 ...
    const int32_t* code32;     // ... or int32
    const int32_t* code_tv;    // K1: code -> candidates
    int64_t code_count;
    const int64_t* seg_rows;   // segment -> vertex
    const int64_t* seg_start;  // split buckets: first row of each segment, then n
    const int64_t* own_seg;    // segment -> output rank
    const int32_t* tv;         // K1: the label tv; K2: the state's tv
    const uint8_t* alive_rev;  // K2: alive bit of each slot's reverse edge
    const uint8_t* alive;      // K2: the state's alive flags
    const uint8_t* flag;       // K2: the state's token-passing flags
    int64_t num_vertices;
    int64_t num_slots;
    int32_t ranks;
    int32_t* new_tv;
    uint8_t* new_alive;
    unsigned long long* stats;  // [av per rank | ae per rank | msg per rank | died]
};

struct Acc {
    uint32_t tn = 0;    // OR of the accepted candidates
    uint32_t send = 0;  // slots whose sender sends (p != 0)
};

struct Cnt {  // one output rank: a thread's sums
    uint32_t av = 0, ae = 0, msg = 0;
};

struct Tally {  // counting: a register group's 16 counts, 4 bits each
    uint32_t lo = 0, hi = 0;
};

__device__ __forceinline__ uint32_t nibble(uint32_t x) {
    // four 0/1 bytes -> four bits
    return (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
}

__device__ __forceinline__ uint32_t bits8(uint2 v) { return nibble(v.x) | (nibble(v.y) << 4); }

__device__ __forceinline__ uint32_t spread4(uint32_t b) {
    // four bits -> four 0/1 bytes
    return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

__device__ __forceinline__ uint32_t spread_nibbles(uint32_t b) {
    // eight bits -> eight 0/1 nibbles
    b = (b | (b << 12)) & 0x000f000fu;
    b = (b | (b << 6)) & 0x03030303u;
    return (b | (b << 3)) & 0x11111111u;
}

__device__ __forceinline__ uint32_t add_nibbles(uint32_t a, uint32_t b) {
    // eight 4-bit counts, each sum saturating at 15
    const uint32_t s = (a & 0x77777777u) + (b & 0x77777777u);
    const uint32_t sum = s ^ ((a ^ b) & 0x88888888u);
    const uint32_t carry = ((a & b) | (s & (a | b))) & 0x88888888u;
    return sum | ((carry >> 3) * 0xfu);
}

// counting: one accepted slot of class c (1..L; 0 counts nowhere) with
// candidates p, into the counts of group g
__device__ __forceinline__ void tally_slot(uint32_t p, uint32_t c, const Req& rq, int g, Tally& t) {
    uint32_t hit = 0;
#pragma unroll
    for (int q = 0; q < kGroupPairs; ++q) {
        const uint32_t w = rq.pair[g * kGroupPairs + q];
        hit |= static_cast<uint32_t>(((w >> 16) & 0xfu) + 1u == c && (p & w & 0xffffu) != 0) << q;
    }
    if (hit) {
        t.lo = add_nibbles(t.lo, spread_nibbles(hit & 0xffu));
        t.hi = add_nibbles(t.hi, spread_nibbles(hit >> 8));
    }
}

// counting: the candidates whose requirements of group g the counts meet
__device__ __forceinline__ uint32_t group_keep(const Tally& t, const Req& rq, int g) {
    uint32_t keep = 0xffffffffu;
#pragma unroll
    for (int q = 0; q < kGroupPairs; ++q) {
        const uint32_t w = rq.pair[g * kGroupPairs + q];
        const uint32_t cnt = ((q < 8 ? t.lo : t.hi) >> (4 * (q & 7))) & 0xfu;
        if (cnt < ((w >> 24) & 0xfu)) keep &= ~(1u << ((w >> 20) & 0xfu));
    }
    return keep;
}

// warp mode: the counts of a segment's L lanes met in every one of them
__device__ __forceinline__ Tally meet_lanes(Tally t, int L) {
    for (int off = 1; off < L; off <<= 1) {
        t.lo = add_nibbles(t.lo, __shfl_xor_sync(kFull, t.lo, off));
        t.hi = add_nibbles(t.hi, __shfl_xor_sync(kFull, t.hi, off));
    }
    return t;
}

// block mode: a warp's counts as eight words of two 16-bit fields (32
// lanes of at most 15 each cannot carry across a field), summed over the
// warp into s_tal[.][warp]
__device__ __forceinline__ void tally_to_shared(const Tally& t, uint32_t (*s_tal)[kWarps],
                                                int warp, int lane) {
#pragma unroll
    for (int h = 0; h < 8; ++h) {
        const uint32_t x = (h < 4 ? t.lo : t.hi) >> (8 * (h & 3));
        const uint32_t sum = __reduce_add_sync(kFull, (x & 0xfu) | ((x & 0xf0u) << 12));
        if (lane == 0) s_tal[h][warp] = sum;
    }
}

// block mode: the counts of the P warps from `first`, saturated to 4 bits
__device__ __forceinline__ Tally tally_from_shared(uint32_t (*s_tal)[kWarps], int first,
                                                   int P) {
    Tally t;
#pragma unroll
    for (int h = 0; h < 8; ++h) {
        uint32_t sum = 0;  // at most 8 warps x 32 lanes x 15 a field
        for (int j = first; j < first + P; ++j) sum += s_tal[h][j];
        const uint32_t a = min(sum & 0xffffu, 15u), b = min(sum >> 16, 15u);
        const uint32_t two = (a | (b << 4)) << (8 * (h & 3));
        if (h < 4) t.lo |= two; else t.hi |= two;
    }
    return t;
}

__device__ __forceinline__ uint32_t byte_of(uint2 v, int k) {
    return ((k < 4 ? v.x : v.y) >> (8 * (k & 3))) & 0xffu;
}

__device__ __forceinline__ uint32_t or_over_bits(uint32_t tvs, const Tmpl& tm) {
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
        if (i < tm.k && ((tvs >> i) & 1u)) m |= tm.adj_all[i];
    }
    return m;
}

__device__ __forceinline__ uint32_t keep_mask(uint32_t tn, const Tmpl& tm) {
    uint32_t keep = 0;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
        if (i >= tm.k) break;
        bool ok = (tm.mand[i] & ~tn) == 0;
        if (tm.opt_min[i] > 0) {
            const uint32_t t = tm.opt[i] & tn;
            ok = ok && t == tm.opt[i] && __popc(t) >= tm.opt_min[i];
        }
        keep |= static_cast<uint32_t>(ok) << i;
    }
    return keep;
}

// The segment's new tv from its tv and its tn, and whether it died: at
// init a segment that heard nothing is out of the map (tv 0, not died).
// count_keep: the counting mode's mask of candidates whose counts met
// their requirements (all ones in the default mode).
template <bool kInit>
__device__ __forceinline__ uint32_t new_tv_of(uint32_t tvs, uint32_t tn, const Tmpl& tm,
                                              uint32_t count_keep, bool& died) {
    if (kInit && tn == 0) {
        died = false;
        return 0u;
    }
    const uint32_t nt = tvs & keep_mask(tn, tm) & count_keep;
    died = (kInit || tvs != 0) && nt == 0;
    return nt;
}

// one slot whose sender's candidates are p: its accept bit
__device__ __forceinline__ uint32_t accept_slot(uint32_t p, uint32_t m, Acc& acc) {
    if (p == 0) return 0u;
    acc.send += 1;
    if ((p & m) == 0) return 0u;
    acc.tn |= p;
    return 1u;
}

// accept_slot, and in the counting mode the accepted slot counted with its
// sender's class c
template <bool kCounting>
__device__ __forceinline__ uint32_t take(uint32_t p, uint32_t m, Acc& acc, uint32_t c,
                                         const ReqT<kCounting>& rq, int g, Tally& t) {
    const uint32_t bit = accept_slot(p, m, acc);
    if constexpr (kCounting) {
        if (bit) tally_slot(p, c, rq, g, t);
    }
    return bit;
}

template <bool kCode8>
__device__ __forceinline__ uint32_t candidates(const Planes& pl, const int32_t* s_ctv, uint32_t c) {
    if (kCode8) return static_cast<uint32_t>(s_ctv[c]);
    return c < pl.code_count ? static_cast<uint32_t>(__ldg(pl.code_tv + c)) : 0u;
}

// The streamed inputs of a lane's step of vec slots from s (8-aligned when
// vec is 8): K1 the label codes; K2 the alive_rev, alive and tp_flag
// bytes. Loaded apart from their use so that block mode can keep two
// steps' loads in flight.
template <bool kCounting>
struct Raw {
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    uint4 b = make_uint4(0u, 0u, 0u, 0u);
};
template <>
struct Raw<true> {
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    uint4 b = make_uint4(0u, 0u, 0u, 0u);
    uint2 c = make_uint2(0u, 0u);  // K1: the class bytes
};

template <bool kInit, bool kCode8, bool kCounting>
__device__ __forceinline__ Raw<kCounting> load_step(const Planes& pl, const ReqT<kCounting>& rq,
                                                    int64_t s, int vec) {
    Raw<kCounting> r;
    if constexpr (kInit && kCounting) {
        if (vec == 8) {
            r.c = __ldcs(reinterpret_cast<const uint2*>(rq.cls + s));
        } else {
            r.c.x = rq.cls[s];
        }
    }
    if (vec == 8) {
        if (kInit && kCode8) {
            const uint2 v = __ldcs(reinterpret_cast<const uint2*>(pl.code8 + s));
            r.a.x = v.x;
            r.a.y = v.y;
        } else if (kInit) {
            r.a = __ldcs(reinterpret_cast<const uint4*>(pl.code32 + s));
            r.b = __ldcs(reinterpret_cast<const uint4*>(pl.code32 + s + 4));
        } else {
            const uint2 rev = __ldcs(reinterpret_cast<const uint2*>(pl.alive_rev + s));
            const uint2 al = __ldcs(reinterpret_cast<const uint2*>(pl.alive + s));
            const uint2 fl = __ldcs(reinterpret_cast<const uint2*>(pl.flag + s));
            r.a = make_uint4(rev.x, rev.y, al.x, al.y);
            r.b.x = fl.x;
            r.b.y = fl.y;
        }
    } else if (kInit) {
        r.a.x = kCode8 ? pl.code8[s] : static_cast<uint32_t>(pl.code32[s]);
    } else {
        r.a = make_uint4(pl.alive_rev[s], pl.alive[s], pl.flag[s], 0u);
    }
    return r;
}

// K2, one slot whose reverse edge is alive: p = tv[adj], 0 at the sentinel
__device__ __forceinline__ uint32_t tv_at(const Planes& pl, int32_t a) {
    return static_cast<uint32_t>(a) < static_cast<uint64_t>(pl.num_vertices)
               ? static_cast<uint32_t>(__ldg(pl.tv + a))
               : 0u;
}

// a lane's step from its loaded inputs: its output bits before the live
// test (K1: accept; K2: own_alive & (accept | own_flag)). K2 reads adj, the
// tv entries and (counting) the class bytes only for the slots whose
// alive_rev is set. Counting: the accepted slots into group g's counts.
template <bool kInit, bool kCode8, bool kCounting>
__device__ __forceinline__ uint32_t run_step(const Planes& pl, const int32_t* s_ctv, int64_t s,
                                             int vec, const Raw<kCounting>& r, uint32_t m,
                                             Acc& acc, const ReqT<kCounting>& rq, int g, Tally& t) {
    if (kInit) {
        uint2 cl = make_uint2(0u, 0u);
        if constexpr (kCounting) cl = r.c;
        if (vec != 8) {
            return take<kCounting>(candidates<kCode8>(pl, s_ctv, r.a.x), m, acc, cl.x, rq, g, t);
        }
        uint32_t c[8];
        if (kCode8) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                c[k] = (r.a.x >> (8 * k)) & 0xffu;
                c[k + 4] = (r.a.y >> (8 * k)) & 0xffu;
            }
        } else {
            c[0] = r.a.x; c[1] = r.a.y; c[2] = r.a.z; c[3] = r.a.w;
            c[4] = r.b.x; c[5] = r.b.y; c[6] = r.b.z; c[7] = r.b.w;
        }
        uint32_t bits = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            bits |= take<kCounting>(candidates<kCode8>(pl, s_ctv, c[k]), m, acc, byte_of(cl, k),
                                    rq, g, t) << k;
        }
        return bits;
    }
    if (vec != 8) {
        uint32_t cl = 0;
        if constexpr (kCounting) {
            if (r.a.x) cl = rq.cls[s];
        }
        const uint32_t a = r.a.x ? take<kCounting>(tv_at(pl, pl.adj[s]), m, acc, cl, rq, g, t) : 0u;
        return r.a.y & (a | r.a.z);
    }
    const uint32_t rb = bits8(make_uint2(r.a.x, r.a.y));
    uint2 cl = make_uint2(0u, 0u);
    if constexpr (kCounting) {
        if (rb) cl = __ldcs(reinterpret_cast<const uint2*>(rq.cls + s));
    }
    // slot k of the eight, its neighbour a
    auto gather = [&](int32_t a, int k) {
        return take<kCounting>(tv_at(pl, a), m, acc, byte_of(cl, k), rq, g, t) << k;
    };
    uint32_t acc_bits = 0;
    if (rb & 0x0fu) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(pl.adj + s));
        if (rb & 1u) acc_bits |= gather(a.x, 0);
        if (rb & 2u) acc_bits |= gather(a.y, 1);
        if (rb & 4u) acc_bits |= gather(a.z, 2);
        if (rb & 8u) acc_bits |= gather(a.w, 3);
    }
    if (rb & 0xf0u) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(pl.adj + s + 4));
        if (rb & 0x10u) acc_bits |= gather(a.x, 4);
        if (rb & 0x20u) acc_bits |= gather(a.y, 5);
        if (rb & 0x40u) acc_bits |= gather(a.z, 6);
        if (rb & 0x80u) acc_bits |= gather(a.w, 7);
    }
    return bits8(make_uint2(r.a.z, r.a.w)) & (acc_bits | bits8(make_uint2(r.b.x, r.b.y)));
}

__device__ __forceinline__ void store_step(uint8_t* out, int64_t s, int vec, uint32_t bits) {
    if (vec == 8) {
        *reinterpret_cast<uint2*>(out + s) = make_uint2(spread4(bits & 0xfu), spread4(bits >> 4));
    } else {
        out[s] = static_cast<uint8_t>(bits);
    }
}

// a segment's counters: live vertex, alive slots and sends, to its rank
__device__ __forceinline__ void count(const Planes& pl, uint32_t* s_cnt, Cnt& c, int64_t gseg,
                                      bool live, uint32_t ae, uint32_t msg) {
    const int r = pl.ranks;
    if (r == 1) {
        c.av += live;
        c.ae += ae;
        c.msg += msg;
        return;
    }
    const int64_t rank = pl.own_seg[gseg];
    if (r <= kSharedRanks) {
        if (live) atomicAdd(s_cnt + rank, 1u);
        if (ae) atomicAdd(s_cnt + r + rank, ae);
        if (msg) atomicAdd(s_cnt + 2 * r + rank, msg);
    } else {
        if (live) atomicAdd(pl.stats + rank, 1ull);
        if (ae) atomicAdd(pl.stats + r + rank, static_cast<unsigned long long>(ae));
        if (msg) atomicAdd(pl.stats + 2 * r + rank, static_cast<unsigned long long>(msg));
    }
}

// warp mode: a block task is 8 warps x 32/L segments of L lanes
template <bool kInit, bool kCode8, bool kCounting>
__device__ __forceinline__ void warp_segments(const Planes& pl, const Buckets& bt, const Tmpl& tm,
                                              const ReqT<kCounting>& rq, int b, int64_t task,
                                              int warp, int lane, const int32_t* s_ctv,
                                              uint32_t* s_cnt, Cnt& cnt) {
    const int L = bt.group[b], vec = bt.vec[b];
    const int64_t seg = task * bt.per_task[b] + warp * (32 / L) + lane / L;
    const int l_in = lane & (L - 1);
    const bool active = seg < bt.n_seg[b];
    const int64_t gseg = bt.seg_base[b] + seg;
    Acc acc;
    Tally tal;
    uint32_t bits = 0, tvs = 0;
    int64_t v = 0, s = 0;
    if (active) {
        v = pl.seg_rows[gseg];
        tvs = static_cast<uint32_t>(pl.tv[v]);
        s = bt.slot_base[b] + seg * bt.width[b] + l_in * vec;
        bits = run_step<kInit, kCode8, kCounting>(
            pl, s_ctv, s, vec, load_step<kInit, kCode8, kCounting>(pl, rq, s, vec),
            or_over_bits(tvs, tm), acc, rq, 0, tal);
    }
    // lanes past the last segment carry zeros through the shuffles
    for (int off = 1; off < L; off <<= 1) {
        acc.tn |= __shfl_xor_sync(kFull, acc.tn, off);
        acc.send += __shfl_xor_sync(kFull, acc.send, off);
    }
    uint32_t count_keep = 0xffffffffu;
    if constexpr (kCounting) {
        count_keep = group_keep(meet_lanes(tal, L), rq, 0);
        for (int g = 1; g < rq.groups; ++g) {  // a further pass a further group
            Acc again;
            Tally t;
            if (active) {
                run_step<kInit, kCode8, kCounting>(
                    pl, s_ctv, s, vec, load_step<kInit, kCode8, kCounting>(pl, rq, s, vec),
                    or_over_bits(tvs, tm), again, rq, g, t);
            }
            count_keep &= group_keep(meet_lanes(t, L), rq, g);
        }
    }
    bool died = false;
    const uint32_t nt = new_tv_of<kInit>(tvs, acc.tn, tm, count_keep, died);
    const uint32_t out = nt != 0 ? bits : 0u;
    uint32_t ae = __popc(out);
    for (int off = 1; off < L; off <<= 1) ae += __shfl_xor_sync(kFull, ae, off);
    if (!active) return;
    store_step(pl.new_alive, s, vec, out);
    if (l_in == 0) {
        pl.new_tv[v] = static_cast<int32_t>(nt);
        if (died) pl.stats[3 * pl.ranks] = 1ull;
        count(pl, s_cnt, cnt, gseg, nt != 0, ae, acc.send);
    }
}

// block mode: a block task is 8/P segments of P warps (block-uniform: every
// thread reaches every barrier)
template <bool kInit, bool kCode8, bool kCounting>
__device__ __forceinline__ void block_segments(const Planes& pl, const Buckets& bt, const Tmpl& tm,
                                               const ReqT<kCounting>& rq, int b, int64_t task,
                                               int warp, int lane, const int32_t* s_ctv,
                                               uint32_t (*s_red)[kWarps],
                                               uint32_t (*s_tal)[kWarps], uint32_t* s_cnt,
                                               Cnt& cnt) {
    const int P = bt.group[b], vec = bt.vec[b];
    const int64_t w = bt.width[b];
    const int grp = warp / P, sub = warp - grp * P;
    const int64_t seg = task * bt.per_task[b] + grp;
    const bool active = seg < bt.n_seg[b];
    const int64_t gseg = bt.seg_base[b] + seg;
    const int64_t stride = static_cast<int64_t>(P) * 32 * vec;
    Acc acc;
    Tally tal;
    uint32_t tvs = 0, set = 0;
    int64_t v = 0, first = 0, hi = 0;
    if (active) {
        v = pl.seg_rows[gseg];
        tvs = static_cast<uint32_t>(pl.tv[v]);
        const uint32_t m = or_over_bits(tvs, tm);
        int64_t lo = bt.slot_base[b] + seg * w;
        hi = lo + w;
        if (bt.split[b]) {
            const int64_t* st = pl.seg_start + bt.start_base[b] + seg;
            lo = bt.slot_base[b] + st[0] * w;
            hi = bt.slot_base[b] + st[1] * w;
        }
        first = lo + static_cast<int64_t>(sub * 32 + lane) * vec;
        // two steps a turn, both steps' loads issued before either is used
        for (int64_t s = first; s < hi; s += 2 * stride) {
            const bool two = s + stride < hi;
            const Raw<kCounting> r0 = load_step<kInit, kCode8, kCounting>(pl, rq, s, vec);
            const Raw<kCounting> r1 =
                two ? load_step<kInit, kCode8, kCounting>(pl, rq, s + stride, vec)
                    : Raw<kCounting>{};
            const uint32_t b0 =
                run_step<kInit, kCode8, kCounting>(pl, s_ctv, s, vec, r0, m, acc, rq, 0, tal);
            store_step(pl.new_alive, s, vec, b0);
            set += __popc(b0);
            if (two) {
                const uint32_t b1 = run_step<kInit, kCode8, kCounting>(pl, s_ctv, s + stride, vec,
                                                                       r1, m, acc, rq, 0, tal);
                store_step(pl.new_alive, s + stride, vec, b1);
                set += __popc(b1);
            }
        }
    }
    const uint32_t wrote = set;
    acc.tn = __reduce_or_sync(kFull, acc.tn);
    acc.send = __reduce_add_sync(kFull, acc.send);
    set = __reduce_add_sync(kFull, set);
    if constexpr (kCounting) tally_to_shared(tal, s_tal, warp, lane);
    if (lane == 0) {
        s_red[0][warp] = acc.tn;
        s_red[1][warp] = acc.send;
        s_red[2][warp] = set;
    }
    __syncthreads();
    uint32_t tn = 0, send = 0, ae = 0;
    for (int j = grp * P; j < grp * P + P; ++j) {
        tn |= s_red[0][j];
        send += s_red[1][j];
        ae += s_red[2][j];
    }
    uint32_t count_keep = 0xffffffffu;
    if constexpr (kCounting) count_keep = group_keep(tally_from_shared(s_tal, grp * P, P), rq, 0);
    __syncthreads();  // every warp has read s_red before the next task writes it
    if constexpr (kCounting) {
        for (int g = 1; g < rq.groups; ++g) {  // a further pass a further group
            Acc again;
            Tally t;
            if (active) {
                const uint32_t m = or_over_bits(tvs, tm);
                for (int64_t s = first; s < hi; s += stride) {
                    run_step<kInit, kCode8, kCounting>(
                        pl, s_ctv, s, vec, load_step<kInit, kCode8, kCounting>(pl, rq, s, vec), m,
                        again, rq, g, t);
                }
            }
            tally_to_shared(t, s_tal, warp, lane);
            __syncthreads();
            count_keep &= group_keep(tally_from_shared(s_tal, grp * P, P), rq, g);
            __syncthreads();
        }
    }
    bool died = false;
    const uint32_t nt = new_tv_of<kInit>(tvs, tn, tm, count_keep, died);
    if (!active) return;
    if (nt == 0 && wrote != 0) {
        // a dead segment keeps no slot alive: clear this lane's own slots
        for (int64_t s = first; s < hi; s += stride) store_step(pl.new_alive, s, vec, 0u);
    }
    if (sub == 0 && lane == 0) {
        pl.new_tv[v] = static_cast<int32_t>(nt);
        if (died) pl.stats[3 * pl.ranks] = 1ull;
        count(pl, s_cnt, cnt, gseg, nt != 0, nt != 0 ? ae : 0u, send);
    }
}

template <bool kInit, bool kCode8, bool kCounting>
__global__ void __launch_bounds__(kThreads)
superstep_kernel(const __grid_constant__ Planes pl, const __grid_constant__ Buckets bt,
                 const __grid_constant__ Tmpl tm, const __grid_constant__ ReqT<kCounting> rq) {
    __shared__ int32_t s_ctv[kSharedCodes];
    __shared__ uint32_t s_red[3][kWarps];
    __shared__ uint32_t s_tal[kCounting ? 8 : 1][kWarps];  // counting: a group's fields
    extern __shared__ uint32_t s_cnt[];  // 3 per rank, up to kSharedRanks ranks
    const int n_cnt = pl.ranks <= kSharedRanks ? 3 * pl.ranks : 0;
    for (int i = threadIdx.x; i < n_cnt; i += kThreads) s_cnt[i] = 0;
    if (kInit && kCode8) {
        for (int i = threadIdx.x; i < kSharedCodes; i += kThreads) {
            s_ctv[i] = i < pl.code_count ? pl.code_tv[i] : 0;
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) pl.new_alive[pl.num_slots] = 0;  // the pad slot
    __syncthreads();

    const int warp = static_cast<int>(threadIdx.x >> 5);
    const int lane = static_cast<int>(threadIdx.x & 31u);
    Cnt cnt;
    const int64_t total = bt.task_end[bt.count - 1];
    int i = 0;
    // tasks ascend in a block's loop, so its range index only grows
    for (int64_t t = blockIdx.x; t < total; t += gridDim.x) {
        while (t >= bt.task_end[i]) ++i;
        const int b = bt.order[i];
        const int64_t task = t - (i ? bt.task_end[i - 1] : 0);
        if (bt.warp_mode[b]) {
            warp_segments<kInit, kCode8, kCounting>(pl, bt, tm, rq, b, task, warp, lane, s_ctv,
                                                    s_cnt, cnt);
        } else {
            block_segments<kInit, kCode8, kCounting>(pl, bt, tm, rq, b, task, warp, lane, s_ctv,
                                                     s_red, s_tal, s_cnt, cnt);
        }
    }

    if (pl.ranks == 1) {
        cnt.av = __reduce_add_sync(kFull, cnt.av);
        cnt.ae = __reduce_add_sync(kFull, cnt.ae);
        cnt.msg = __reduce_add_sync(kFull, cnt.msg);
        if (lane == 0) {
            atomicAdd(s_cnt + 0, cnt.av);
            atomicAdd(s_cnt + 1, cnt.ae);
            atomicAdd(s_cnt + 2, cnt.msg);
        }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n_cnt; j += kThreads) {
        if (s_cnt[j]) atomicAdd(pl.stats + j, static_cast<unsigned long long>(s_cnt[j]));
    }
}

// The bucket table (n, w, slot_base, seg_base, split per bucket) -> the
// launch's Buckets: each bucket's mode and lane mapping, its task count,
// and the order of the task ranges (split buckets, then wider first, so
// that the longest tasks start first). Returns false on a table the
// kernels do not take.
bool map_buckets(const int64_t* table, int32_t count, int64_t total_segs, bool vec_ok,
                 Buckets* bt, int64_t* num_slots) {
    if (count < 1 || count > kMaxBuckets) return false;
    *bt = Buckets{};
    bt->count = count;
    int64_t slots = 0, starts = 0;
    for (int i = 0; i < count; ++i) {
        const int64_t* row = table + 5 * i;
        const int64_t n = row[0], w = row[1], slot_base = row[2], seg_base = row[3];
        const bool split = row[4] != 0;
        const int64_t seg_end = i + 1 < count ? table[5 * (i + 1) + 3] : total_segs;
        const int64_t n_seg = seg_end - seg_base;
        if (n < 0 || w < 1 || w > (int64_t(1) << 30) || slot_base != slots || n_seg < 0 ||
            (!split && n_seg != n) || (split && n_seg > n)) {
            return false;
        }
        const bool pow2 = (w & (w - 1)) == 0;
        const bool vec8 = vec_ok && w % 8 == 0 && slot_base % 8 == 0;
        int warp_mode = 0, vec = 1, group = 1;
        if (!split && pow2 && vec8 && w <= 256) {
            warp_mode = 1, vec = 8, group = static_cast<int>(w / 8);
        } else if (!split && pow2 && w <= 32) {
            warp_mode = 1, vec = 1, group = static_cast<int>(w);
        } else {
            vec = vec8 ? 8 : 1;
            group = split ? kWarps : 1;
            while (group < kWarps && int64_t(group) * 2 * 32 * vec <= w) group *= 2;
        }
        bt->width[i] = static_cast<int32_t>(w);
        bt->warp_mode[i] = warp_mode;
        bt->vec[i] = vec;
        bt->group[i] = group;
        bt->per_task[i] = warp_mode ? kWarps * (32 / group) : kWarps / group;
        bt->split[i] = split;
        bt->n_seg[i] = n_seg;
        bt->slot_base[i] = slot_base;
        bt->seg_base[i] = seg_base;
        bt->start_base[i] = split ? starts : -1;
        if (split) starts += n_seg + 1;
        slots += n * w;
    }
    // split buckets first, then by width, widest first
    for (int i = 0; i < count; ++i) bt->order[i] = i;
    for (int i = 1; i < count; ++i) {
        const int x = bt->order[i];
        int j = i;
        auto before = [&](int a, int c) {
            return bt->split[a] != bt->split[c] ? bt->split[a] > bt->split[c]
                                                : bt->width[a] > bt->width[c];
        };
        while (j > 0 && before(x, bt->order[j - 1])) {
            bt->order[j] = bt->order[j - 1];
            --j;
        }
        bt->order[j] = x;
    }
    int64_t tasks = 0;
    for (int i = 0; i < count; ++i) {
        const int b = bt->order[i];
        tasks += (bt->n_seg[b] + bt->per_task[b] - 1) / bt->per_task[b];
        bt->task_end[i] = tasks;
    }
    *num_slots = slots;
    return true;
}

bool read_template(const int64_t* words, Tmpl* tm) {
    *tm = Tmpl{};
    tm->k = static_cast<int32_t>(words[0]);
    if (tm->k < 1 || tm->k > kMaxK) return false;
    for (int i = 0; i < kMaxK; ++i) {
        tm->adj_all[i] = static_cast<uint32_t>(words[1 + i]);
        tm->mand[i] = static_cast<uint32_t>(words[1 + kMaxK + i]);
        tm->opt[i] = static_cast<uint32_t>(words[1 + 2 * kMaxK + i]);
        tm->opt_min[i] = static_cast<int32_t>(words[1 + 3 * kMaxK + i]);
    }
    return true;
}

// Counting: the requirement table required[i, j] (16 x 16 words after the
// template's, row i for template vertex i, 0 past k and past L) -> its
// pairs. Every entry is 0..15.
bool read_required(const int64_t* words, const Tmpl& tm, Req* rq) {
    const uint8_t* cls = rq->cls;
    *rq = Req{};
    rq->cls = cls;
    int n = 0;
    for (int i = 0; i < kMaxK; ++i) {
        for (int j = 0; j < kMaxClasses; ++j) {
            const int64_t r = words[1 + 4 * kMaxK + kMaxClasses * i + j];
            if (r < 0 || r > 15 || (r > 0 && i >= tm.k)) return false;
            if (r == 0) continue;
            rq->pair[n++] = (tm.adj_all[i] & 0xffffu) | (static_cast<uint32_t>(j) << 16) |
                            (static_cast<uint32_t>(i) << 20) | (static_cast<uint32_t>(r) << 24);
        }
    }
    rq->groups = n > kGroupPairs ? (n + kGroupPairs - 1) / kGroupPairs : 1;
    return true;
}

bool read_rule(const int64_t*, const Tmpl&, NoReq*) { return true; }
bool read_rule(const int64_t* words, const Tmpl& tm, Req* rq) {
    return read_required(words, tm, rq);
}

template <bool kInit, bool kCode8, bool kCounting>
int launch(Planes pl, const int64_t* table, int32_t count, int64_t total_segs, bool vec_ok,
           const int64_t* tmpl_words, const void* cls, cudaStream_t stream) {
    Buckets bt;
    Tmpl tm;
    ReqT<kCounting> rq{};
    if constexpr (kCounting) rq.cls = static_cast<const uint8_t*>(cls);
    if (pl.ranks < 1 || !read_template(tmpl_words, &tm) || !read_rule(tmpl_words, tm, &rq) ||
        !map_buckets(table, count, total_segs, vec_ok, &bt, &pl.num_slots)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t tasks = bt.task_end[count - 1];
    if (tasks == 0) return static_cast<int>(cudaGetLastError());
    auto kernel = superstep_kernel<kInit, kCode8, kCounting>;
    const size_t smem = sizeof(uint32_t) * 3 * (pl.ranks <= kSharedRanks ? pl.ranks : 0);
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
    const int64_t cap = static_cast<int64_t>(sm_count()) * per_sm;
    const int blocks = static_cast<int>(tasks < cap ? tasks : cap);
    kernel<<<blocks, kThreads, smem, stream>>>(pl, bt, tm, rq);
    return static_cast<int>(cudaGetLastError());
}

Planes common_planes(const void* seg_rows, const void* seg_start, const void* own_seg,
                     const void* tv, int64_t num_vertices, int32_t ranks, void* new_tv,
                     void* new_alive, void* stats) {
    Planes pl{};
    pl.seg_rows = static_cast<const int64_t*>(seg_rows);
    pl.seg_start = static_cast<const int64_t*>(seg_start);
    pl.own_seg = static_cast<const int64_t*>(own_seg);
    pl.tv = static_cast<const int32_t*>(tv);
    pl.num_vertices = num_vertices;
    pl.ranks = ranks;
    pl.new_tv = static_cast<int32_t*>(new_tv);
    pl.new_alive = static_cast<uint8_t*>(new_alive);
    pl.stats = static_cast<unsigned long long*>(stats);
    return pl;
}

template <bool kCounting>
int init_entry(const void* code, int32_t code_bytes, const void* code_tv, int64_t code_count,
               const void* cls, const int64_t* table, int32_t count, int64_t total_segs,
               const void* seg_rows, const void* seg_start, const void* own_seg, const void* tv,
               int64_t num_vertices, const int64_t* tmpl, int32_t ranks, void* new_tv,
               void* new_alive, void* stats, void* stream) {
    Planes pl = common_planes(seg_rows, seg_start, own_seg, tv, num_vertices, ranks, new_tv,
                              new_alive, stats);
    pl.code_tv = static_cast<const int32_t*>(code_tv);
    pl.code_count = code_count;
    const bool cls_ok = !kCounting || aligned(cls, 8);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (code_bytes == 1) {
        if (code_count > kSharedCodes) return static_cast<int>(cudaErrorInvalidValue);
        pl.code8 = static_cast<const uint8_t*>(code);
        const bool vec_ok = aligned(code, 8) && aligned(new_alive, 8) && cls_ok;
        return launch<true, true, kCounting>(pl, table, count, total_segs, vec_ok, tmpl, cls, st);
    }
    if (code_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
    pl.code32 = static_cast<const int32_t*>(code);
    const bool vec_ok = aligned(code, 16) && aligned(new_alive, 8) && cls_ok;
    return launch<true, false, kCounting>(pl, table, count, total_segs, vec_ok, tmpl, cls, st);
}

template <bool kCounting>
int continuation_entry(const void* adj, const void* alive_rev, const void* alive,
                       const void* flag, const void* cls, const int64_t* table, int32_t count,
                       int64_t total_segs, const void* seg_rows, const void* seg_start,
                       const void* own_seg, const void* tv, int64_t num_vertices,
                       const int64_t* tmpl, int32_t ranks, void* new_tv, void* new_alive,
                       void* stats, void* stream) {
    Planes pl = common_planes(seg_rows, seg_start, own_seg, tv, num_vertices, ranks, new_tv,
                              new_alive, stats);
    pl.adj = static_cast<const int32_t*>(adj);
    pl.alive_rev = static_cast<const uint8_t*>(alive_rev);
    pl.alive = static_cast<const uint8_t*>(alive);
    pl.flag = static_cast<const uint8_t*>(flag);
    const bool vec_ok = aligned(adj, 16) && aligned(alive_rev, 8) && aligned(alive, 8) &&
                        aligned(flag, 8) && aligned(new_alive, 8) &&
                        (!kCounting || aligned(cls, 8));
    return launch<false, false, kCounting>(pl, table, count, total_segs, vec_ok, tmpl, cls,
                                           static_cast<cudaStream_t>(stream));
}

}  // namespace

// K1. code: uint8 (code_bytes 1) or int32 (4) label code per slot;
// code_tv: int32 [code_count]. table: count rows (n, w, slot_base,
// seg_base, split); total_segs: segments of all buckets. tmpl: k, then
// adj_all, mand, opt and opt_min, 16 entries each. Outputs: new_tv
// (zeroed by the caller), new_alive [S + 1] (every slot written), stats
// [3 ranks + 1] (zeroed by the caller).
extern "C" int fpm_init_superstep(const void* code, int32_t code_bytes, const void* code_tv,
                                  int64_t code_count, const int64_t* table, int32_t count,
                                  int64_t total_segs, const void* seg_rows, const void* seg_start,
                                  const void* own_seg, const void* tv, int64_t num_vertices,
                                  const int64_t* tmpl, int32_t ranks, void* new_tv,
                                  void* new_alive, void* stats, void* stream) {
    return init_entry<false>(code, code_bytes, code_tv, code_count, nullptr, table, count,
                             total_segs, seg_rows, seg_start, own_seg, tv, num_vertices, tmpl,
                             ranks, new_tv, new_alive, stats, stream);
}

// K2. adj: int32 [S]; alive_rev: bool [S]; alive, flag: bool [S + 1]; the
// rest as for K1, tv being the state's.
extern "C" int fpm_continuation_superstep(const void* adj, const void* alive_rev,
                                          const void* alive, const void* flag,
                                          const int64_t* table, int32_t count,
                                          int64_t total_segs, const void* seg_rows,
                                          const void* seg_start, const void* own_seg,
                                          const void* tv, int64_t num_vertices,
                                          const int64_t* tmpl, int32_t ranks, void* new_tv,
                                          void* new_alive, void* stats, void* stream) {
    return continuation_entry<false>(adj, alive_rev, alive, flag, nullptr, table, count,
                                     total_segs, seg_rows, seg_start, own_seg, tv, num_vertices,
                                     tmpl, ranks, new_tv, new_alive, stats, stream);
}

// K1 under the counting rule. cls: uint8 [S], the label class (1..L, 0
// none) of each slot's sender; tmpl: K1's words, then required[i, j] as
// 16 x 16 words (row i, column j; 0..15). The rest as for K1.
extern "C" int fpm_init_superstep_counting(const void* code, int32_t code_bytes,
                                           const void* code_tv, int64_t code_count,
                                           const void* cls, const int64_t* table, int32_t count,
                                           int64_t total_segs, const void* seg_rows,
                                           const void* seg_start, const void* own_seg,
                                           const void* tv, int64_t num_vertices,
                                           const int64_t* tmpl, int32_t ranks, void* new_tv,
                                           void* new_alive, void* stats, void* stream) {
    return init_entry<true>(code, code_bytes, code_tv, code_count, cls, table, count, total_segs,
                            seg_rows, seg_start, own_seg, tv, num_vertices, tmpl, ranks, new_tv,
                            new_alive, stats, stream);
}

// K2 under the counting rule: cls and tmpl as for
// fpm_init_superstep_counting, the rest as for K2.
extern "C" int fpm_continuation_superstep_counting(const void* adj, const void* alive_rev,
                                                   const void* alive, const void* flag,
                                                   const void* cls, const int64_t* table,
                                                   int32_t count, int64_t total_segs,
                                                   const void* seg_rows, const void* seg_start,
                                                   const void* own_seg, const void* tv,
                                                   int64_t num_vertices, const int64_t* tmpl,
                                                   int32_t ranks, void* new_tv, void* new_alive,
                                                   void* stats, void* stream) {
    return continuation_entry<true>(adj, alive_rev, alive, flag, cls, table, count, total_segs,
                                    seg_rows, seg_start, own_seg, tv, num_vertices, tmpl, ranks,
                                    new_tv, new_alive, stats, stream);
}
