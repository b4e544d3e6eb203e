// Hand-written Hopper (sm_90a) kernels of the device NLCC token walk (K4).
//
// They replace what fuzzypatternmatching_tpu/engine/nlcc_device.py left to
// XLA, not to Pallas:
//
//   * expand_frontier replaces DeviceNlcc._expand (nlcc_device.py:105) and
//     the hop filters applied to its output (:146-149, :167-170, :200-204):
//     the ragged expansion of a token frontier over the alive CSR, with the
//     parent-return drop, the message counts and the hop's arrival test
//     fused, writing only the lanes that survive.
//   * forward_winners replaces the per-(vertex, source) winner of one nem
//     hop (nlcc_device.py:188-199): the membership test against the keys
//     forwarded before and the sorted (key, parent) first-of-run rule.
//
// There the frontier was a fixed power-of-two capacity, doubled and
// recompiled on overflow. Here every output is sized exactly: the wrapper
// (ops/nlcc_frontier.py) reads the hop's lane total and survivor total
// from the device, so nothing overflows.
//
// expand_frontier. Bound by bytes: each lane reads its 4-byte neighbour
// from col (contiguous within a row); a survivor writes 8 bytes. After the
// first hop most lanes fail the arrival test (at R-MAT s21, hop 3 of the
// cycle corpus keeps 2 % of 74 M lanes). Load balance: rows are ragged
// (R-MAT hubs hold tens of thousands of neighbours), so the lanes, not the
// tokens, are split: a warp takes chunks of kChunk consecutive lanes of the
// flattened expansion (a merge-path split) and finds the token of each
// lane among the chunk's tokens. Two passes keep the output exact and in
// lane order: pass 1 counts the survivors of each chunk (and the messages,
// per receiving rank); the wrapper's cumsum gives each chunk its output
// offset; pass 2 writes the chunk's survivors.
//
// First design (expand_count_kernel / expand_write_kernel): one warp per
// chunk, the token of each lane by a binary search in memory, the arrival
// bit read from the lane's int32 ok_bits word. It takes the unfiltered hops
// (h_next = -1, TDS) and the filtered hops of fewer than PLANE_MIN_LANES
// lanes (ops/nlcc_frontier.py), where its small fixed cost wins.
//
// Plane design (plane_count_kernel / plane_write_kernel), for the large
// filtered hops. What held the first design back at s21 hop 3 (1.51 ms
// against a 0.099 ms bound, H100 80GB HBM3 at 700 W) was one random ok_bits
// read per message, in both passes, and per-lane searches and loads. Here:
//
//   * the hop's bit is a 1-bit plane (bit_plane_kernel, built per call
//     from ok_bits: 8 MB read at s21) and a summary of it, one bit per
//     2^g vertices (plane_summary_kernel), the finest that fits one CTA's
//     shared memory: g = 1 at s21 (128 KB; 1 % of the vertices, 3.3 % of
//     the messages land on a set summary bit). Every CTA of a persistent
//     grid stages the summary once with a TMA bulk copy (cp.async.bulk,
//     completion on an mbarrier); a lane reads the exact bit from the
//     plane (device memory, L2-resident) only where its summary bit is set;
//   * a warp walks a contiguous run of chunks, carrying the token position
//     from one chunk to the next; a chunk of at most 32 tokens holds them
//     one a lane in registers (lane end, col base, parent), and a thread
//     takes kRun consecutive lanes, so the per-lane work is one col load;
//   * pass 1 stores one keep bit per lane, so pass 2 reads only the
//     survivors' neighbours and no plane at all.
//
// Two other ways to hold the bit were measured at s21 hop 3 and lost to
// the summary: the whole plane in the shared memory of a 2-CTA cluster,
// read through distributed shared memory (0.69 ms), and the plane read
// through __ldg (0.65 ms), against 0.47 ms (H100 80GB HBM3, 700 W). A
// random 4-byte read of a peer CTA's shared memory costs about what an
// L2-resident read does.
//
// forward_winners. A lane wins iff its key (v * V + src) was not forwarded
// before and its parent is the smallest among the lanes of that key, ties
// going to the earlier lane: exactly the stable sort by (key, parent) of
// the JAX package and the host engine's lexsort. Every earlier key is an
// entry with value 0 and every lane an entry with value (parent + 1) << 32
// | lane; a lane wins iff its value is the minimum of its key's entries.
// Bound by bytes: keys, parents and the earlier keys read once, the flags
// written once.
//
// First design (winner_insert_kernel / winner_mark_kernel): one global
// open-addressing table of at least twice the entries, filled by the
// wrapper, 64-bit global atomics; it takes the calls of fewer than
// WINNER_PARTITION_MIN entries. Partitioned design, for the large calls:
//
//   * pass A hashes each entry (splitmix64's finaliser) into one of P
//     partitions by the hash's high bits: a shared-memory histogram, one
//     block scan of the P counts, and a scatter into partition order; the
//     scatter sorts each tile by partition in shared memory and writes it
//     out in runs (random 16-byte stores into fresh memory were its cost);
//   * pass B gives each partition one CTA, which builds an open-addressing
//     table of twice its entries in shared memory, keeps each key's
//     minimum with 64-bit shared-memory atomicMin, and flags each lane
//     entry whose value stayed, in entry order; a last pass gathers the
//     flags into lane order. The host picks P for about 1,024 entries a
//     partition (so that P CTAs fill the card, several to an SM) and sizes
//     the tables to twice the expected share with a margin; a partition
//     that does not fit anyway builds its table in global scratch memory
//     (same code, a branch of the kernel). The minimum does not depend on
//     the order of the atomics, so the result is deterministic.
//
// Plain C entry points (bound with ctypes): each launches on the stream it
// is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the launch's error) so that a refused launch is
// reported to the caller.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Lanes of the flattened expansion per chunk (a warp's unit of work). Must
// equal EXPAND_CHUNK in ops/nlcc_frontier.py.
constexpr int64_t kChunk = 256;
constexpr int kRun = static_cast<int>(kChunk / 32);  // lanes per thread, plane kernels
using KeepWord = uint8_t;  // a thread's keep bits, one per lane of its run
// Per-rank message counters live in shared memory up to this many ranks,
// and go straight to global atomics above it.
constexpr int kMaxSharedRanks = 4096;
constexpr unsigned long long kEmpty = ~0ull;
// Dynamic shared memory of one block on sm_90: 227 KB.
constexpr int kMaxSmem = 232448;
// The most shared memory the plane count kernel stages per CTA: the plane's
// summary (SUMMARY_BYTES in ops/nlcc_frontier.py).
constexpr int64_t kSummaryBytes = 231424;
constexpr int kPlaneThreads = 1024;
constexpr int kPlaneWarps = kPlaneThreads / 32;
// Hash partitions of forward_winners at most (MAX_PARTITIONS).
constexpr int kMaxPartitionsLog2 = 12;
constexpr int kScanThreads = 1024;
constexpr int kScatterItems = 8;
constexpr int kScatterThreads = 512;
constexpr int kScatterTile = kScatterThreads * kScatterItems;
constexpr int kTableThreads = 256;
constexpr int kGatherItems = 4;  // lanes a gather thread takes, loads issued together

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

int grid_for(int64_t work_items, int64_t per_block) {
    int64_t blocks = (work_items + per_block - 1) / per_block;
    return static_cast<int>(blocks > 0 ? blocks : 1);
}

// First i in [lo, hi) with a[i] > x; hi if there is none.
__device__ __forceinline__ int64_t upper_bound(const int64_t* __restrict__ a, int64_t lo,
                                               int64_t hi, int64_t x) {
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (__ldg(a + mid) > x) {
            hi = mid;
        } else {
            lo = mid + 1;
        }
    }
    return lo;
}

// upper_bound by a whole warp (every lane gets the answer): 32 probes per
// step, first galloping out from lo by windows of 32, 1,024, 32,768, ...
// entries until a probe exceeds x, then narrowing the window 32-fold per
// step. An answer near lo (the next chunk's first token) costs one
// coalesced probe.
__device__ __forceinline__ int64_t warp_upper_bound(const int64_t* __restrict__ a, int64_t lo,
                                                    int64_t hi, int64_t x, unsigned lane) {
    if (lo >= hi) return hi;
    int64_t step = 1;
    while (true) {
        // a[i] <= x for every i < lo; the answer lies in [lo, hi]
        const int64_t pos = lo + static_cast<int64_t>(lane + 1) * step - 1;
        const bool above = pos >= hi || __ldg(a + pos) > x;
        const unsigned ballot = __ballot_sync(kFull, above);
        if (ballot == 0) {
            lo += 32 * step;
            step <<= 5;
            continue;
        }
        const int k = __ffs(ballot) - 1;
        const int64_t k_lo = lo + k * step;
        const int64_t k_hi = lo + (k + 1) * step - 1;  // a[k_hi] > x, or k_hi >= hi
        if (step == 1) return k_lo < hi ? k_lo : hi;
        lo = k_lo;
        if (k_hi < hi) hi = k_hi;
        step >>= 5;
    }
}

// Stage `bytes` (a multiple of 16, 16-byte aligned) from global memory into
// this CTA's shared memory with one TMA bulk copy, completion on an
// mbarrier; every thread of the CTA returns once the bytes have landed.
__device__ __forceinline__ void stage_to_shared(void* dst, const void* src, uint32_t bytes,
                                                uint64_t* bar) {
    const uint32_t bar_addr = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
    const uint32_t dst_addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(bar_addr), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            ::"r"(dst_addr), "l"(src), "r"(bytes), "r"(bar_addr) : "memory");
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar_addr), "r"(0u) : "memory");
    } while (!done);
}

// ---------------------------------------------------------------------------
// expand_frontier, first design: one warp per chunk, the arrival bit read
// from the int32 ok_bits word.

struct ExpandArgs {
    const int64_t* __restrict__ ptr;       // [V + 1] alive CSR offsets
    const int32_t* __restrict__ col;       // [A] alive CSR neighbours
    const int32_t* __restrict__ cur;       // [F] token vertices
    const int32_t* __restrict__ parent;    // [F] vertex each token came from
    const int64_t* __restrict__ lane_end;  // [F] inclusive lane offsets
    const int64_t* __restrict__ tok_base;  // [F] col index of lane 0, less the token's first lane
    const uint32_t* __restrict__ ok_bits;  // [V] arrival bits per vertex
    int64_t n_tok;
    int64_t lanes;
    int h_next;
    int num_ranks;
    bool drop;  // drop the lane back to the token's parent (plane kernels)
};

// One lane of the flattened expansion: its token (t is advanced from the
// token of an earlier lane of this thread, or the chunk's first token),
// its neighbour, and whether it is a message and a survivor.
template <bool kFilter, bool kDrop>
__device__ __forceinline__ void visit(const ExpandArgs& a, int64_t lane, int64_t& t,
                                      int64_t t_end, int32_t& nbr, bool& msg, bool& keep) {
    t = upper_bound(a.lane_end, t, t_end, lane);
    const int64_t start = t > 0 ? __ldg(a.lane_end + t - 1) : 0;
    const int32_t v = __ldg(a.cur + t);
    nbr = __ldg(a.col + __ldg(a.ptr + v) + (lane - start));
    msg = !kDrop || nbr != __ldg(a.parent + t);
    keep = msg && (!kFilter || ((__ldg(a.ok_bits + nbr) >> a.h_next) & 1u) != 0u);
}

// The chunk's token range: [t, t_end) holds every token with a lane in
// [first, last).
__device__ __forceinline__ void chunk_tokens(const ExpandArgs& a, int64_t first, int64_t last,
                                             int64_t& t, int64_t& t_end) {
    t = upper_bound(a.lane_end, 0, a.n_tok, first);
    t_end = upper_bound(a.lane_end, t, a.n_tok, last - 1) + 1;
}

// A message to rank nbr % num_ranks: counted in a register (one rank), in
// shared memory, or by a global atomic.
__device__ __forceinline__ void count_message(int num_ranks, bool shared_ranks, int32_t nbr,
                                              uint32_t& msgs, unsigned long long* s_msg,
                                              unsigned long long* msg_per_rank) {
    if (num_ranks == 1) {
        ++msgs;
    } else if (shared_ranks) {
        atomicAdd(&s_msg[nbr % num_ranks], 1ull);
    } else {
        atomicAdd(msg_per_rank + nbr % num_ranks, 1ull);
    }
}

// The block's message counts into msg_per_rank (after a barrier).
__device__ __forceinline__ void flush_messages(int num_ranks, bool shared_ranks, uint32_t msgs,
                                               const unsigned long long* s_msg,
                                               unsigned long long* msg_per_rank) {
    if (num_ranks == 1) {
        msgs = __reduce_add_sync(kFull, msgs);
        if ((threadIdx.x & 31u) == 0 && msgs != 0) {
            atomicAdd(msg_per_rank, static_cast<unsigned long long>(msgs));
        }
    } else if (shared_ranks) {
        for (int r = threadIdx.x; r < num_ranks; r += blockDim.x) {
            if (s_msg[r] != 0) atomicAdd(msg_per_rank + r, s_msg[r]);
        }
    }
}

template <bool kFilter, bool kDrop>
__global__ void __launch_bounds__(kThreads)
expand_count_kernel(ExpandArgs a, int32_t* __restrict__ chunk_count,
                    unsigned long long* __restrict__ msg_per_rank) {
    extern __shared__ unsigned long long s_msg[];
    const bool shared_ranks = a.num_ranks > 1 && a.num_ranks <= kMaxSharedRanks;
    if (shared_ranks) {
        for (int r = threadIdx.x; r < a.num_ranks; r += blockDim.x) s_msg[r] = 0;
        __syncthreads();
    }
    const unsigned lane = threadIdx.x & 31u;
    const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    const int64_t first = chunk * kChunk;
    uint32_t msgs = 0;
    if (first < a.lanes) {  // warp-uniform
        const int64_t last = first + kChunk < a.lanes ? first + kChunk : a.lanes;
        int64_t t, t_end;
        chunk_tokens(a, first, last, t, t_end);
        uint32_t kept = 0;
        for (int64_t base = first; base < last; base += 32) {
            const int64_t l = base + lane;
            bool keep = false;
            if (l < last) {
                int32_t nbr;
                bool msg;
                visit<kFilter, kDrop>(a, l, t, t_end, nbr, msg, keep);
                if (msg) count_message(a.num_ranks, shared_ranks, nbr, msgs, s_msg, msg_per_rank);
            }
            kept += __popc(__ballot_sync(kFull, keep));
        }
        if (lane == 0) chunk_count[chunk] = static_cast<int32_t>(kept);
    }
    if (shared_ranks) __syncthreads();
    flush_messages(a.num_ranks, shared_ranks, msgs, s_msg, msg_per_rank);
}

template <bool kFilter, bool kDrop>
__global__ void __launch_bounds__(kThreads)
expand_write_kernel(ExpandArgs a, const int32_t* __restrict__ chunk_count,
                    const int64_t* __restrict__ chunk_start, int32_t* __restrict__ out_tok,
                    int32_t* __restrict__ out_nbr) {
    const unsigned lane = threadIdx.x & 31u;
    const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    const int64_t first = chunk * kChunk;
    if (first >= a.lanes || __ldg(chunk_count + chunk) == 0) return;  // warp-uniform
    const int64_t last = first + kChunk < a.lanes ? first + kChunk : a.lanes;
    int64_t t, t_end;
    chunk_tokens(a, first, last, t, t_end);
    int64_t pos = __ldg(chunk_start + chunk);
    for (int64_t base = first; base < last; base += 32) {
        const int64_t l = base + lane;
        bool keep = false;
        int32_t nbr = 0;
        if (l < last) {
            bool msg;
            visit<kFilter, kDrop>(a, l, t, t_end, nbr, msg, keep);
        }
        const unsigned ballot = __ballot_sync(kFull, keep);
        if (keep) {
            const int64_t p = pos + __popc(ballot & ((1u << lane) - 1u));
            out_tok[p] = static_cast<int32_t>(t);
            out_nbr[p] = nbr;
        }
        pos += __popc(ballot);
    }
}

// ---------------------------------------------------------------------------
// expand_frontier, plane design: the hop's arrival bits as a 1-bit plane,
// its summary in every CTA's shared memory.

// bit v % 32 of plane[v / 32] = bit h of ok_bits[v]; words past n are 0.
__global__ void __launch_bounds__(kThreads)
bit_plane_kernel(const uint32_t* __restrict__ ok_bits, int64_t n, int h,
                 uint32_t* __restrict__ plane, int64_t n_words) {
    const unsigned lane = threadIdx.x & 31u;
    const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
    for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); w < n_words;
         w += n_warps) {
        const int64_t v = w * 32 + lane;
        const bool bit = v < n && ((__ldg(ok_bits + v) >> h) & 1u) != 0u;
        const unsigned word = __ballot_sync(kFull, bit);
        if (lane == 0) plane[w] = word;
    }
}

// Summary bit q = OR of plane bits [q * 2^group_log2, (q + 1) * 2^group_log2);
// one thread per summary word.
__global__ void __launch_bounds__(kThreads)
plane_summary_kernel(const uint32_t* __restrict__ plane, int64_t n_words, int group_log2,
                     uint32_t* __restrict__ summary, int64_t summary_words) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t sw = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         sw < summary_words; sw += stride) {
        uint32_t out = 0;
        for (int b = 0; b < 32; ++b) {
            const int64_t lo = (sw * 32 + b) << group_log2;  // first vertex of the group
            const int64_t hi = lo + (int64_t(1) << group_log2);
            bool any = false;
            if (group_log2 < 5) {
                const int64_t w = lo >> 5;
                const uint32_t mask = ((1u << (1 << group_log2)) - 1u) << (lo & 31);
                any = w < n_words && (__ldg(plane + w) & mask) != 0u;
            } else {
                for (int64_t w = lo >> 5; w < (hi >> 5) && w < n_words && !any; ++w) {
                    any = __ldg(plane + w) != 0u;
                }
            }
            if (any) out |= 1u << b;
        }
        summary[sw] = out;
    }
}

struct PlaneArgs {
    const uint32_t* __restrict__ plane;    // the hop's bit plane (device memory)
    const uint32_t* __restrict__ summary;  // its summary, staged in shared memory
    uint32_t summary_words;
    int group_log2;    // a summary bit per 2^group_log2 vertices (0: the plane)
    int shared_ranks;  // per-rank counters in shared memory
};

// The kRun lanes first + kRun * lane + m (m < kRun) of the chunk [first,
// last), whose first token is t0: each one's token and neighbour, and bit m
// of msg / keep for a message / a survivor. Returns the chunk's last token.
//
// A thread takes kRun consecutive lanes, which mostly belong to one token.
// A chunk of at most 32 tokens (the rule after the first hop) holds them
// one a lane: lane j loads token t0 + j's lane end, col base and parent,
// once per chunk. A thread finds the token of its first lane by a binary
// search over those registers (shuffles), then walks its lanes, moving to
// the next token where a lane crosses a token's end; each lane reads only
// its neighbour from memory. A chunk of more tokens searches the lane
// offsets in memory, lane by lane.
//
// kKnown (the write pass): keep is given, from the count pass; only the
// survivors' neighbours are read, and no arrival bit.
template <bool kKnown>
__device__ __forceinline__ int64_t chunk_run(const ExpandArgs& a, const PlaneArgs& p,
                                             const uint32_t* s_summary, int64_t first, int64_t last,
                                             int64_t t0, unsigned lane, int32_t (&tok)[kRun],
                                             int32_t (&nbr)[kRun], unsigned& msg,
                                             unsigned& keep) {
    const int64_t t = t0 + lane;
    const int64_t end = t < a.n_tok ? __ldg(a.lane_end + t) : INT64_MAX;
    const unsigned inside = __ballot_sync(kFull, end < last);  // a prefix of the lanes
    const int32_t r0 = static_cast<int32_t>(lane) * kRun;      // first lane, relative
    const int32_t span = static_cast<int32_t>(last - first);
    const int valid = span - r0 >= kRun ? kRun : (span > r0 ? span - r0 : 0);
    int64_t t_last;
    msg = 0;
    if (inside != kFull) {
        const int n = __popc(inside) + 1;  // tokens t0 .. t0 + n - 1
        int32_t e = INT32_MAX;  // lane end relative to first (the last token's: kChunk)
        int64_t base = 0;       // col index of the token's relative lane 0
        int32_t par = 0;
        if (static_cast<int>(lane) < n) {
            e = static_cast<int>(lane) == n - 1 ? static_cast<int32_t>(kChunk)
                                                : static_cast<int32_t>(end - first);
            base = __ldg(a.tok_base + t) + first;
            if (a.drop) par = __ldg(a.parent + t);
        }
        int j = 0;  // tokens of the chunk ending at or before the thread's first lane
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
            if (__shfl_sync(kFull, e, j + step - 1) <= r0) j += step;
        }
        int32_t e_cur = __shfl_sync(kFull, e, j);
        const int32_t* run = a.col + (__shfl_sync(kFull, base, j) + r0);
        int32_t p_cur = __shfl_sync(kFull, par, j);
#pragma unroll
        for (int m = 0; m < kRun; ++m) {
            // the next token (a zero-degree token ends where the one before it does)
            while (__any_sync(kFull, r0 + m >= e_cur)) {
                if (r0 + m >= e_cur) ++j;
                e_cur = __shfl_sync(kFull, e, j);
                run = a.col + (__shfl_sync(kFull, base, j) + r0);
                p_cur = __shfl_sync(kFull, par, j);
            }
            tok[m] = static_cast<int32_t>(t0 + j);
            nbr[m] = 0;
            if (kKnown) {
                if ((keep >> m) & 1u) nbr[m] = __ldg(run + m);
            } else if (m < valid) {
                nbr[m] = __ldg(run + m);
                if (!a.drop || nbr[m] != p_cur) msg |= 1u << m;
            }
        }
        t_last = t0 + n - 1;
    } else {
        // more than 32 tokens: the first 32 end before last
        const int64_t t_end = warp_upper_bound(a.lane_end, t0 + 32, a.n_tok, last - 1, lane) + 1;
        int64_t tk = t0;
#pragma unroll
        for (int m = 0; m < kRun; ++m) {
            tok[m] = 0;
            nbr[m] = 0;
            if (m < valid && (!kKnown || ((keep >> m) & 1u))) {
                const int64_t l = first + r0 + m;
                tk = upper_bound(a.lane_end, tk, t_end, l);
                tok[m] = static_cast<int32_t>(tk);
                nbr[m] = __ldg(a.col + __ldg(a.tok_base + tk) + l);
                if (!a.drop || nbr[m] != __ldg(a.parent + tk)) msg |= 1u << m;
            }
        }
        t_last = t_end - 1;
    }
    if (kKnown) return t_last;
    // the summary bits first, then the exact bits of the lanes that pass,
    // their loads issued together
    unsigned pass = 0;
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
        const uint32_t q = static_cast<uint32_t>(nbr[m]) >> p.group_log2;
        if (((msg >> m) & 1u) && ((s_summary[q >> 5] >> (q & 31u)) & 1u)) pass |= 1u << m;
    }
    if (p.group_log2 == 0) {  // the summary is the plane
        keep = pass;
        return t_last;
    }
    uint32_t word[kRun];
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
        const uint32_t u = static_cast<uint32_t>(nbr[m]);
        word[m] = ((pass >> m) & 1u) ? __ldg(p.plane + (u >> 5)) : 0u;
    }
    keep = 0;
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
        if ((word[m] >> (static_cast<uint32_t>(nbr[m]) & 31u)) & 1u) keep |= 1u << m;
    }
    return t_last;
}

// Shared memory of the plane count kernel: the summary, then the per-rank
// counters. Stages the summary and waits until it has landed.
__device__ __forceinline__ void plane_prologue(const ExpandArgs& a, const PlaneArgs& p,
                                               unsigned char* smem, uint64_t* bar,
                                               unsigned long long*& s_msg) {
    s_msg = reinterpret_cast<unsigned long long*>(smem + static_cast<size_t>(p.summary_words) * 4);
    stage_to_shared(smem, p.summary, p.summary_words * 4u, bar);
    if (p.shared_ranks) {
        for (int r = threadIdx.x; r < a.num_ranks; r += blockDim.x) s_msg[r] = 0;
    }
    __syncthreads();
}

// The contiguous run of chunks of this warp: the chunks split evenly over
// every warp of the grid.
__device__ __forceinline__ void warp_chunks(int64_t n_chunks, int64_t& begin, int64_t& end) {
    const int64_t warps = static_cast<int64_t>(gridDim.x) * kPlaneWarps;
    const int64_t per = (n_chunks + warps - 1) / warps;
    begin = (static_cast<int64_t>(blockIdx.x) * kPlaneWarps + (threadIdx.x >> 5)) * per;
    end = begin + per < n_chunks ? begin + per : n_chunks;
}

__global__ void __launch_bounds__(kPlaneThreads, 1)
plane_count_kernel(ExpandArgs a, PlaneArgs p, int64_t n_chunks, int32_t* __restrict__ chunk_count,
                   KeepWord* __restrict__ keep_bits, int32_t* __restrict__ chunk_t0,
                   unsigned long long* __restrict__ msg_per_rank) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) uint64_t bar;
    unsigned long long* s_msg;
    plane_prologue(a, p, smem, &bar, s_msg);
    const uint32_t* s_summary = reinterpret_cast<const uint32_t*>(smem);
    const unsigned lane = threadIdx.x & 31u;
    uint32_t msgs = 0;
    int64_t c, c_end;
    warp_chunks(n_chunks, c, c_end);
    int64_t t_lo = 0;  // no token of this chunk lies below it
    for (; c < c_end; ++c) {
        const int64_t first = c * kChunk;
        const int64_t last = first + kChunk < a.lanes ? first + kChunk : a.lanes;
        const int64_t t0 = warp_upper_bound(a.lane_end, t_lo, a.n_tok, first, lane);
        int32_t tok[kRun], nbr[kRun];
        unsigned msg, keep;
        const int64_t t_last =
            chunk_run<false>(a, p, s_summary, first, last, t0, lane, tok, nbr, msg, keep);
        keep_bits[c * 32 + lane] = static_cast<KeepWord>(keep);
        if (lane == 0) chunk_t0[c] = static_cast<int32_t>(t0);
        if (a.num_ranks == 1) {
            msgs += __popc(msg);
        } else {
#pragma unroll
            for (int m = 0; m < kRun; ++m) {
                if ((msg >> m) & 1u) {
                    count_message(a.num_ranks, p.shared_ranks, nbr[m], msgs, s_msg, msg_per_rank);
                }
            }
        }
        const unsigned kept = __reduce_add_sync(kFull, __popc(keep));
        if (lane == 0) chunk_count[c] = static_cast<int32_t>(kept);
        t_lo = t_last;
    }
    __syncthreads();
    flush_messages(a.num_ranks, p.shared_ranks, msgs, s_msg, msg_per_rank);
}

// Pass 2 of the plane design: each chunk's survivors, from pass 1's keep
// bits (one bit per lane, kRun a thread) and first token: only the
// survivors' neighbours are read, and no plane or summary.
__global__ void __launch_bounds__(kPlaneThreads, 1)
plane_write_kernel(ExpandArgs a, int64_t n_chunks, const int32_t* __restrict__ chunk_count,
                   const KeepWord* __restrict__ keep_bits, const int32_t* __restrict__ chunk_t0,
                   const int64_t* __restrict__ chunk_start, int32_t* __restrict__ out_tok,
                   int32_t* __restrict__ out_nbr) {
    const PlaneArgs p = {};  // not read when keep is known
    const unsigned lane = threadIdx.x & 31u;
    int64_t c, c_end;
    warp_chunks(n_chunks, c, c_end);
    for (; c < c_end; ++c) {
        if (__ldg(chunk_count + c) == 0) continue;  // warp-uniform
        const int64_t first = c * kChunk;
        const int64_t last = first + kChunk < a.lanes ? first + kChunk : a.lanes;
        int32_t tok[kRun], nbr[kRun];
        unsigned msg, keep = __ldg(keep_bits + c * 32 + lane);
        chunk_run<true>(a, p, nullptr, first, last, __ldg(chunk_t0 + c), lane, tok, nbr, msg,
                        keep);
        // the thread's survivors follow those of the lanes before it
        const unsigned mine = __popc(keep);
        unsigned below = mine;  // inclusive scan over the warp
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned y = __shfl_up_sync(kFull, below, o);
            if (lane >= static_cast<unsigned>(o)) below += y;
        }
        int64_t pos = __ldg(chunk_start + c) + (below - mine);
#pragma unroll
        for (int m = 0; m < kRun; ++m) {
            if ((keep >> m) & 1u) {
                out_tok[pos] = tok[m];
                out_nbr[pos] = nbr[m];
                ++pos;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// forward_winners

__device__ __forceinline__ uint64_t mix(uint64_t k) {
    // splitmix64's finaliser
    k ^= k >> 30;
    k *= 0xbf58476d1ce4e5b9ull;
    k ^= k >> 27;
    k *= 0x94d049bb133111ebull;
    k ^= k >> 31;
    return k;
}

__device__ __forceinline__ unsigned long long lane_value(const int32_t* __restrict__ parents,
                                                         int64_t j) {
    return (static_cast<unsigned long long>(__ldg(parents + j) + 1u) << 32) |
           static_cast<unsigned long long>(j);
}

// First design: one global table of `capacity` slots.

__global__ void __launch_bounds__(kThreads)
winner_insert_kernel(const int64_t* __restrict__ seen, int64_t n_seen,
                     const int64_t* __restrict__ keys, const int32_t* __restrict__ parents,
                     int64_t n_lanes, unsigned long long* __restrict__ t_keys,
                     unsigned long long* __restrict__ t_vals, uint64_t mask) {
    const int64_t n = n_seen + n_lanes;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        unsigned long long key, val;
        if (i < n_seen) {
            key = static_cast<unsigned long long>(__ldg(seen + i));
            val = 0ull;  // below every lane's value: its lanes lose
        } else {
            const int64_t j = i - n_seen;
            key = static_cast<unsigned long long>(__ldg(keys + j));
            val = lane_value(parents, j);
        }
        uint64_t slot = mix(key) & mask;
        while (true) {
            const unsigned long long prev = atomicCAS(t_keys + slot, kEmpty, key);
            if (prev == kEmpty || prev == key) {
                atomicMin(t_vals + slot, val);
                break;
            }
            slot = (slot + 1) & mask;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
winner_mark_kernel(const int64_t* __restrict__ keys, const int32_t* __restrict__ parents,
                   int64_t n_lanes, const unsigned long long* __restrict__ t_keys,
                   const unsigned long long* __restrict__ t_vals, uint64_t mask,
                   uint8_t* __restrict__ win) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < n_lanes;
         j += stride) {
        const unsigned long long key = static_cast<unsigned long long>(__ldg(keys + j));
        uint64_t slot = mix(key) & mask;
        while (__ldg(t_keys + slot) != key) slot = (slot + 1) & mask;  // inserted above
        win[j] = __ldg(t_vals + slot) == lane_value(parents, j) ? 1 : 0;
    }
}

// Partitioned design.

struct WinnerArgs {
    const int64_t* __restrict__ seen;
    const int64_t* __restrict__ keys;
    const int32_t* __restrict__ parents;
    int64_t n_seen;
    int64_t n_lanes;
    int log_p;
};

// Entry i: an earlier key (value 0) or lane i - n_seen.
__device__ __forceinline__ void winner_entry(const WinnerArgs& w, int64_t i,
                                             unsigned long long& key,
                                             unsigned long long& val) {
    if (i < w.n_seen) {
        key = static_cast<unsigned long long>(__ldg(w.seen + i));
        val = 0ull;
    } else {
        const int64_t j = i - w.n_seen;
        key = static_cast<unsigned long long>(__ldg(w.keys + j));
        val = lane_value(w.parents, j);
    }
}

__device__ __forceinline__ uint32_t partition_of(unsigned long long key, int log_p) {
    return log_p == 0 ? 0u : static_cast<uint32_t>(mix(key) >> (64 - log_p));
}

// A table slot from the hash's low 32 bits (the partition took the high ones).
__device__ __forceinline__ uint32_t slot_of(unsigned long long key, uint32_t slots) {
    return static_cast<uint32_t>(
        (static_cast<uint64_t>(static_cast<uint32_t>(mix(key))) * slots) >> 32);
}

__global__ void __launch_bounds__(kThreads)
winner_hist_kernel(WinnerArgs w, unsigned long long* __restrict__ p_count) {
    extern __shared__ uint32_t s_hist[];
    const int parts = 1 << w.log_p;
    for (int q = threadIdx.x; q < parts; q += blockDim.x) s_hist[q] = 0;
    __syncthreads();
    const int64_t n = w.n_seen + w.n_lanes;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const unsigned long long key = static_cast<unsigned long long>(
            i < w.n_seen ? __ldg(w.seen + i) : __ldg(w.keys + (i - w.n_seen)));
        atomicAdd(&s_hist[partition_of(key, w.log_p)], 1u);
    }
    __syncthreads();
    for (int q = threadIdx.x; q < parts; q += blockDim.x) {
        if (s_hist[q] != 0) atomicAdd(p_count + q, static_cast<unsigned long long>(s_hist[q]));
    }
}

// Exclusive scan of the partition counts (at most 4 per thread), into the
// partition starts and the scatter cursors.
__global__ void __launch_bounds__(kScanThreads)
winner_scan_kernel(const unsigned long long* __restrict__ p_count, int parts,
                   unsigned long long* __restrict__ p_start,
                   unsigned long long* __restrict__ cursor) {
    __shared__ unsigned long long s_warp[kScanThreads / 32];
    constexpr int kPer = (1 << kMaxPartitionsLog2) / kScanThreads;
    const unsigned lane = threadIdx.x & 31u;
    const unsigned warp = threadIdx.x >> 5;
    const int base = threadIdx.x * kPer;
    unsigned long long v[kPer];
    unsigned long long sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        v[j] = base + j < parts ? p_count[base + j] : 0ull;
        sum += v[j];
    }
    unsigned long long x = sum;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, x, o);
        if (lane >= static_cast<unsigned>(o)) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        unsigned long long t = s_warp[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned long long y = __shfl_up_sync(kFull, t, o);
            if (lane >= static_cast<unsigned>(o)) t += y;
        }
        s_warp[lane] = t;
    }
    __syncthreads();
    unsigned long long excl = x - sum + (warp > 0 ? s_warp[warp - 1] : 0ull);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        if (base + j < parts) {
            p_start[base + j] = excl;
            cursor[base + j] = excl;
        }
        excl += v[j];
    }
}

// Exclusive scan of s_in[0, count) into s_out by the whole block (count
// at most 8 per thread); s_warp holds 32 words.
__device__ __forceinline__ void block_exclusive_scan(const uint32_t* s_in, uint32_t* s_out,
                                                     int count, uint32_t* s_warp) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned warp = threadIdx.x >> 5;
    const int per = (count + static_cast<int>(blockDim.x) - 1) / static_cast<int>(blockDim.x);
    const int base = static_cast<int>(threadIdx.x) * per;
    uint32_t sum = 0;
    for (int j = 0; j < per && base + j < count; ++j) sum += s_in[base + j];
    uint32_t x = sum;  // inclusive over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, x, o);
        if (lane >= static_cast<unsigned>(o)) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        uint32_t t = lane < (blockDim.x >> 5) ? s_warp[lane] : 0u;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t y = __shfl_up_sync(kFull, t, o);
            if (lane >= static_cast<unsigned>(o)) t += y;
        }
        s_warp[lane] = t;
    }
    __syncthreads();
    uint32_t run = x - sum + (warp > 0 ? s_warp[warp - 1] : 0u);
    for (int j = 0; j < per && base + j < count; ++j) {
        s_out[base + j] = run;
        run += s_in[base + j];
    }
}

// Entries into partition order, kScatterTile at a time: each entry's rank
// among the tile's entries of its partition (a shared-memory histogram),
// one global atomic per (tile, partition) to reserve the tile's range,
// then the tile sorted by partition in shared memory and written out in
// runs, so that the stores are contiguous rather than one random 16-byte
// store per entry. lane_pos[lane] is where the lane's entry landed.
__global__ void __launch_bounds__(kScatterThreads)
winner_scatter_kernel(WinnerArgs w, unsigned long long* __restrict__ cursor,
                      ulonglong2* __restrict__ entries, uint32_t* __restrict__ lane_pos) {
    extern __shared__ __align__(16) unsigned char s_bytes[];
    __shared__ uint32_t s_warp[32];
    const int parts = 1 << w.log_p;
    auto* s_stage = reinterpret_cast<ulonglong2*>(s_bytes);                         // [tile]
    auto* s_base = reinterpret_cast<unsigned long long*>(s_stage + kScatterTile);  // [parts]
    uint32_t* s_cnt = reinterpret_cast<uint32_t*>(s_base + parts);                 // [parts]
    uint32_t* s_off = s_cnt + parts;                                               // [parts]
    auto* s_part = reinterpret_cast<uint16_t*>(s_off + parts);                     // [tile]
    const int64_t n = w.n_seen + w.n_lanes;
    for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * kScatterTile; t0 < n;
         t0 += static_cast<int64_t>(gridDim.x) * kScatterTile) {
        const int in_tile = n - t0 < kScatterTile ? static_cast<int>(n - t0) : kScatterTile;
        for (int q = threadIdx.x; q < parts; q += blockDim.x) s_cnt[q] = 0;
        __syncthreads();
        unsigned long long key[kScatterItems], val[kScatterItems];
        uint32_t part[kScatterItems], rank[kScatterItems];
#pragma unroll
        for (int k = 0; k < kScatterItems; ++k) {
            const int64_t i = t0 + k * kScatterThreads + threadIdx.x;
            if (i < n) {
                winner_entry(w, i, key[k], val[k]);
                part[k] = partition_of(key[k], w.log_p);
                rank[k] = atomicAdd(&s_cnt[part[k]], 1u);
            }
        }
        __syncthreads();
        block_exclusive_scan(s_cnt, s_off, parts, s_warp);
        for (int q = threadIdx.x; q < parts; q += blockDim.x) {
            if (s_cnt[q] != 0) {
                s_base[q] = atomicAdd(cursor + q, static_cast<unsigned long long>(s_cnt[q]));
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kScatterItems; ++k) {
            const int64_t i = t0 + k * kScatterThreads + threadIdx.x;
            if (i < n) {
                const uint32_t slot = s_off[part[k]] + rank[k];
                s_stage[slot] = make_ulonglong2(key[k], val[k]);
                s_part[slot] = static_cast<uint16_t>(part[k]);
                if (i >= w.n_seen) {
                    lane_pos[i - w.n_seen] = static_cast<uint32_t>(s_base[part[k]] + rank[k]);
                }
            }
        }
        __syncthreads();
        for (int x = threadIdx.x; x < in_tile; x += blockDim.x) {
            const uint32_t q = s_part[x];
            entries[s_base[q] + (x - s_off[q])] = s_stage[x];
        }
        __syncthreads();  // the shared arrays are reused by the next tile
    }
}

// win[j] = the flag of lane j's entry.
__global__ void __launch_bounds__(kThreads)
winner_gather_kernel(const uint32_t* __restrict__ lane_pos, const uint8_t* __restrict__ flags,
                     int64_t n_lanes, uint8_t* __restrict__ win) {
    const int64_t step = static_cast<int64_t>(blockDim.x) * kGatherItems;
    for (int64_t j0 = blockIdx.x * step + threadIdx.x; j0 < n_lanes; j0 += gridDim.x * step) {
        uint32_t pos[kGatherItems];
#pragma unroll
        for (int k = 0; k < kGatherItems; ++k) {
            const int64_t j = j0 + k * static_cast<int64_t>(blockDim.x);
            pos[k] = j < n_lanes ? __ldg(lane_pos + j) : 0u;
        }
#pragma unroll
        for (int k = 0; k < kGatherItems; ++k) {
            const int64_t j = j0 + k * static_cast<int64_t>(blockDim.x);
            if (j < n_lanes) win[j] = __ldg(flags + pos[k]);
        }
    }
}

// A table slot read after the block's atomics: shared memory, or global
// memory past L1.
template <bool kShared>
__device__ __forceinline__ unsigned long long table_load(const unsigned long long* p) {
    if (kShared) return *p;
    return __ldcg(p);
}

// One partition's entries [start, start + count) against a table of
// `slots` = 2 count slots at tk / tv (shared or global memory): keep each
// key's minimum value, then flag each lane entry whose value stayed (in
// entry order; an earlier key's flag is 0 and never read).
template <bool kShared>
__device__ __forceinline__ void partition_winners(unsigned long long* tk, unsigned long long* tv,
                                                  uint32_t slots,
                                                  const ulonglong2* __restrict__ entries,
                                                  int64_t start, int64_t count,
                                                  uint8_t* __restrict__ flags) {
    for (uint32_t s = threadIdx.x; s < slots; s += blockDim.x) {
        tk[s] = kEmpty;
        tv[s] = kEmpty;
    }
    __syncthreads();
    const int64_t end = start + count;
    for (int64_t e = start + threadIdx.x; e < end; e += blockDim.x) {
        const ulonglong2 entry = entries[e];
        uint32_t s = slot_of(entry.x, slots);
        while (true) {
            const unsigned long long prev = atomicCAS(tk + s, kEmpty, entry.x);
            if (prev == kEmpty || prev == entry.x) {
                atomicMin(tv + s, entry.y);
                break;
            }
            s = s + 1 == slots ? 0 : s + 1;
        }
    }
    __syncthreads();
    for (int64_t e = start + threadIdx.x; e < end; e += blockDim.x) {
        const ulonglong2 entry = entries[e];
        uint8_t flag = 0;
        if (entry.y != 0) {  // a lane (an earlier key has value 0)
            uint32_t s = slot_of(entry.x, slots);
            while (table_load<kShared>(tk + s) != entry.x) s = s + 1 == slots ? 0 : s + 1;
            flag = table_load<kShared>(tv + s) == entry.y ? 1 : 0;
        }
        flags[e] = flag;
    }
}

__global__ void __launch_bounds__(kTableThreads)
winner_table_kernel(const ulonglong2* __restrict__ entries,
                    const unsigned long long* __restrict__ p_start,
                    const unsigned long long* __restrict__ p_count, int parts,
                    uint32_t table_slots, unsigned long long* __restrict__ ovf_key,
                    unsigned long long* __restrict__ ovf_val, uint8_t* __restrict__ flags) {
    extern __shared__ __align__(16) unsigned long long s_table[];  // keys, then values
    for (int q = blockIdx.x; q < parts; q += gridDim.x) {
        const int64_t start = static_cast<int64_t>(p_start[q]);
        const int64_t count = static_cast<int64_t>(p_count[q]);
        if (count == 0) continue;  // block-uniform
        const uint64_t slots = 2 * static_cast<uint64_t>(count);
        if (slots <= table_slots) {
            partition_winners<true>(s_table, s_table + table_slots, static_cast<uint32_t>(slots),
                                    entries, start, count, flags);
        } else {
            // the partition outgrew a shared-memory table: its own table of
            // 2 count slots in the global scratch, at 2 start
            partition_winners<false>(ovf_key + 2 * start, ovf_val + 2 * start,
                                     static_cast<uint32_t>(slots), entries, start, count, flags);
        }
        __syncthreads();  // the table is reused by the block's next partition
    }
}

// ---------------------------------------------------------------------------
// launches

template <bool kFilter, bool kDrop>
cudaError_t launch_count(const ExpandArgs& a, int64_t n_chunks, int32_t* count,
                         unsigned long long* msg, cudaStream_t st) {
    const size_t smem = (a.num_ranks > 1 && a.num_ranks <= kMaxSharedRanks)
                            ? static_cast<size_t>(a.num_ranks) * sizeof(unsigned long long)
                            : 0;
    expand_count_kernel<kFilter, kDrop>
        <<<grid_for(n_chunks, kWarps), kThreads, smem, st>>>(a, count, msg);
    return cudaGetLastError();
}

template <bool kFilter, bool kDrop>
cudaError_t launch_write(const ExpandArgs& a, int64_t n_chunks, const int32_t* count,
                         const int64_t* start, int32_t* tok, int32_t* nbr, cudaStream_t st) {
    expand_write_kernel<kFilter, kDrop>
        <<<grid_for(n_chunks, kWarps), kThreads, 0, st>>>(a, count, start, tok, nbr);
    return cudaGetLastError();
}

// Launch a plane kernel on a persistent grid: as many CTAs as are resident,
// and no more than the chunks need.
template <typename Kernel, typename... Args>
cudaError_t launch_plane(Kernel kernel, size_t smem, int64_t n_chunks, cudaStream_t st,
                         Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPlaneThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int64_t want = (n_chunks + kPlaneWarps - 1) / kPlaneWarps;  // CTAs with work
    const int64_t cap = static_cast<int64_t>(sm_count()) * per_sm;
    const int64_t blocks = want < cap ? want : cap;
    kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kPlaneThreads, smem, st>>>(args...);
    return cudaGetLastError();
}

// The plane arguments, and the dynamic shared memory of the count kernel.
PlaneArgs plane_args(const void* plane, const void* summary, int32_t group_log2,
                     int64_t summary_words, int num_ranks, size_t& smem) {
    PlaneArgs p;
    p.plane = static_cast<const uint32_t*>(plane);
    p.summary = static_cast<const uint32_t*>(summary);
    p.summary_words = static_cast<uint32_t>(summary_words);
    p.group_log2 = group_log2;
    const size_t staged = static_cast<size_t>(p.summary_words) * 4;
    const size_t rank_bytes = static_cast<size_t>(num_ranks) * sizeof(unsigned long long);
    p.shared_ranks = num_ranks > 1 && num_ranks <= kMaxSharedRanks &&
                     staged + rank_bytes <= static_cast<size_t>(kSummaryBytes);
    smem = staged + (p.shared_ranks ? rank_bytes : 0);
    return p;
}

ExpandArgs expand_args(const void* ptr, const void* col, const void* cur, const void* parent,
                       const void* lane_end, int64_t n_tok, int64_t lanes, const void* ok_bits,
                       int32_t h_next, int32_t num_ranks) {
    ExpandArgs a;
    a.ptr = static_cast<const int64_t*>(ptr);
    a.col = static_cast<const int32_t*>(col);
    a.cur = static_cast<const int32_t*>(cur);
    a.parent = static_cast<const int32_t*>(parent);
    a.lane_end = static_cast<const int64_t*>(lane_end);
    a.tok_base = nullptr;
    a.ok_bits = static_cast<const uint32_t*>(ok_bits);
    a.n_tok = n_tok;
    a.lanes = lanes;
    a.h_next = h_next;
    a.num_ranks = num_ranks;
    a.drop = false;
    return a;
}

bool bad_expand_args(int64_t n_tok, int64_t lanes, int32_t h_next, int32_t num_ranks) {
    return n_tok <= 0 || lanes <= 0 || h_next < -1 || h_next > 30 || num_ranks < 1;
}

bool bad_plane_args(int64_t n_tok, const void* summary, int32_t group_log2,
                    int64_t summary_words) {
    // the summary is staged by a bulk copy: 16-byte aligned, whole 16 bytes
    return n_tok >= (int64_t(1) << 31) || (reinterpret_cast<uintptr_t>(summary) & 15) != 0 ||
           summary_words <= 0 || (summary_words & 3) != 0 ||
           summary_words * 4 > kSummaryBytes || group_log2 < 0 || group_log2 > 30;
}

}  // namespace

// Pass 1: survivors per chunk of kChunk lanes (int32 [ceil(lanes / kChunk)])
// and messages per rank (uint64 [num_ranks], added to). h_next = -1 keeps
// every message lane (no arrival test).
extern "C" int fpm_expand_count(const void* ptr, const void* col, const void* cur,
                                const void* parent, const void* lane_end, int64_t n_tok,
                                int64_t lanes, const void* ok_bits, int32_t h_next,
                                int32_t num_ranks, int32_t drop_parent_return,
                                void* chunk_count, void* msg_per_rank, void* stream) {
    if (bad_expand_args(n_tok, lanes, h_next, num_ranks)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const ExpandArgs a =
        expand_args(ptr, col, cur, parent, lane_end, n_tok, lanes, ok_bits, h_next, num_ranks);
    const int64_t n_chunks = (lanes + kChunk - 1) / kChunk;
    auto* count = static_cast<int32_t*>(chunk_count);
    auto* msg = static_cast<unsigned long long*>(msg_per_rank);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool filter = h_next >= 0;
    cudaError_t err;
    if (filter && drop_parent_return) {
        err = launch_count<true, true>(a, n_chunks, count, msg, st);
    } else if (filter) {
        err = launch_count<true, false>(a, n_chunks, count, msg, st);
    } else if (drop_parent_return) {
        err = launch_count<false, true>(a, n_chunks, count, msg, st);
    } else {
        err = launch_count<false, false>(a, n_chunks, count, msg, st);
    }
    return static_cast<int>(err);
}

// Pass 2: the survivors (token index, neighbour), in lane order, at the
// offsets chunk_start (int64, exclusive cumsum of pass 1's counts).
extern "C" int fpm_expand_write(const void* ptr, const void* col, const void* cur,
                                const void* parent, const void* lane_end, int64_t n_tok,
                                int64_t lanes, const void* ok_bits, int32_t h_next,
                                int32_t num_ranks, int32_t drop_parent_return,
                                const void* chunk_count, const void* chunk_start, void* out_tok,
                                void* out_nbr, void* stream) {
    if (bad_expand_args(n_tok, lanes, h_next, num_ranks)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const ExpandArgs a =
        expand_args(ptr, col, cur, parent, lane_end, n_tok, lanes, ok_bits, h_next, num_ranks);
    const int64_t n_chunks = (lanes + kChunk - 1) / kChunk;
    auto* count = static_cast<const int32_t*>(chunk_count);
    auto* start = static_cast<const int64_t*>(chunk_start);
    auto* tok = static_cast<int32_t*>(out_tok);
    auto* nbr = static_cast<int32_t*>(out_nbr);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool filter = h_next >= 0;
    cudaError_t err;
    if (filter && drop_parent_return) {
        err = launch_write<true, true>(a, n_chunks, count, start, tok, nbr, st);
    } else if (filter) {
        err = launch_write<true, false>(a, n_chunks, count, start, tok, nbr, st);
    } else if (drop_parent_return) {
        err = launch_write<false, true>(a, n_chunks, count, start, tok, nbr, st);
    } else {
        err = launch_write<false, false>(a, n_chunks, count, start, tok, nbr, st);
    }
    return static_cast<int>(err);
}

// The hop's bit plane: bit v % 32 of word v / 32 = bit h of ok_bits[v]
// (n entries), zero past n, n_words words.
extern "C" int fpm_bit_plane(const void* ok_bits, int64_t n, int32_t h, void* plane,
                             int64_t n_words, void* stream) {
    if (n <= 0 || h < 0 || h > 31 || n_words < (n + 31) / 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
    const int64_t want = grid_for(n_words, kWarps);
    bit_plane_kernel<<<static_cast<int>(want < cap ? want : cap), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ok_bits), n, h, static_cast<uint32_t*>(plane), n_words);
    return static_cast<int>(cudaGetLastError());
}

// The summary of the hop's bit plane (n_words words): bit q = OR of the
// plane's bits [q * 2^group_log2, (q + 1) * 2^group_log2), summary_words
// words.
extern "C" int fpm_plane_summary(const void* plane, int64_t n_words, int32_t group_log2,
                                 void* summary, int64_t summary_words, void* stream) {
    if (n_words <= 0 || group_log2 < 0 || group_log2 > 30 || summary_words <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
    const int64_t want = grid_for(summary_words, kThreads);
    plane_summary_kernel<<<static_cast<int>(want < cap ? want : cap), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(plane), n_words, group_log2,
        static_cast<uint32_t*>(summary), summary_words);
    return static_cast<int>(cudaGetLastError());
}

// Pass 1 of a filtered hop (0 <= h_next <= 30) against the hop's bit plane:
// its summary of 2^group_log2 vertices a bit (summary_words words; the
// plane itself where group_log2 is 0) in each CTA's shared memory, the
// exact bit read from the plane where the summary bit is set. tok_base[t]
// is the col index of token t's lane 0 less the token's first lane
// (ptr[cur[t]] - lane_end[t] + its lanes). Outputs as fpm_expand_count,
// and each lane's keep bit (uint8 [32 * chunks]) and each chunk's first
// token (int32 [chunks]) for pass 2.
extern "C" int fpm_plane_count(const void* ptr, const void* col, const void* cur,
                               const void* parent, const void* lane_end, const void* tok_base,
                               int64_t n_tok, int64_t lanes, int32_t h_next, int32_t num_ranks,
                               int32_t drop_parent_return, const void* plane,
                               const void* summary, int32_t group_log2, int64_t summary_words,
                               void* chunk_count, void* keep_bits, void* chunk_t0,
                               void* msg_per_rank, void* stream) {
    if (bad_expand_args(n_tok, lanes, h_next, num_ranks) || h_next < 0 ||
        bad_plane_args(n_tok, summary, group_log2, summary_words)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    ExpandArgs a =
        expand_args(ptr, col, cur, parent, lane_end, n_tok, lanes, nullptr, h_next, num_ranks);
    a.tok_base = static_cast<const int64_t*>(tok_base);
    a.drop = drop_parent_return != 0;
    size_t smem;
    const PlaneArgs p = plane_args(plane, summary, group_log2, summary_words, num_ranks, smem);
    const int64_t n_chunks = (lanes + kChunk - 1) / kChunk;
    return static_cast<int>(launch_plane(
        plane_count_kernel, smem, n_chunks, static_cast<cudaStream_t>(stream), a, p, n_chunks,
        static_cast<int32_t*>(chunk_count), static_cast<KeepWord*>(keep_bits),
        static_cast<int32_t*>(chunk_t0), static_cast<unsigned long long*>(msg_per_rank)));
}

// Pass 2 of the plane design: the survivors, from pass 1's keep bits (uint8
// [32 * chunks]) and each chunk's first token (int32 [chunks]); outputs as
// fpm_expand_write.
extern "C" int fpm_plane_write(const void* ptr, const void* col, const void* cur,
                               const void* parent, const void* lane_end, const void* tok_base,
                               int64_t n_tok, int64_t lanes, const void* keep_bits,
                               const void* chunk_t0, const void* chunk_count,
                               const void* chunk_start, void* out_tok, void* out_nbr,
                               void* stream) {
    if (n_tok <= 0 || lanes <= 0 || n_tok >= (int64_t(1) << 31)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    ExpandArgs a = expand_args(ptr, col, cur, parent, lane_end, n_tok, lanes, nullptr, 0, 1);
    a.tok_base = static_cast<const int64_t*>(tok_base);
    const int64_t n_chunks = (lanes + kChunk - 1) / kChunk;
    return static_cast<int>(launch_plane(
        plane_write_kernel, 0, n_chunks, static_cast<cudaStream_t>(stream), a, n_chunks,
        static_cast<const int32_t*>(chunk_count), static_cast<const KeepWord*>(keep_bits),
        static_cast<const int32_t*>(chunk_t0), static_cast<const int64_t*>(chunk_start),
        static_cast<int32_t*>(out_tok), static_cast<int32_t*>(out_nbr)));
}

// Winner flags (uint8 [n_lanes]) of one nem hop, first design. t_keys and
// t_vals are [capacity] 64-bit words filled with all ones by the caller;
// capacity is a power of two above n_seen + n_lanes.
extern "C" int fpm_forward_winners(const void* seen, int64_t n_seen, const void* keys,
                                   const void* parents, int64_t n_lanes, void* t_keys,
                                   void* t_vals, int64_t capacity, void* win, void* stream) {
    if (n_lanes <= 0 || n_seen < 0 || capacity <= n_seen + n_lanes ||
        (capacity & (capacity - 1)) != 0 || n_lanes >= (int64_t(1) << 32)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint64_t mask = static_cast<uint64_t>(capacity - 1);
    auto* tk = static_cast<unsigned long long*>(t_keys);
    auto* tv = static_cast<unsigned long long*>(t_vals);
    const int64_t cap_blocks = 132 * 16;
    const int64_t want_insert = (n_seen + n_lanes + kThreads - 1) / kThreads;
    const int64_t want_mark = (n_lanes + kThreads - 1) / kThreads;
    winner_insert_kernel<<<static_cast<int>(want_insert < cap_blocks ? want_insert : cap_blocks),
                           kThreads, 0, st>>>(
        static_cast<const int64_t*>(seen), n_seen, static_cast<const int64_t*>(keys),
        static_cast<const int32_t*>(parents), n_lanes, tk, tv, mask);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    winner_mark_kernel<<<static_cast<int>(want_mark < cap_blocks ? want_mark : cap_blocks),
                         kThreads, 0, st>>>(
        static_cast<const int64_t*>(keys), static_cast<const int32_t*>(parents), n_lanes, tk, tv,
        mask, static_cast<uint8_t*>(win));
    return static_cast<int>(cudaGetLastError());
}

// Winner flags (uint8 [n_lanes]) of one nem hop, partitioned design: 2^log_p
// hash partitions, shared-memory tables of table_slots slots at most.
// Scratch, uninitialised (n = n_seen + n_lanes): entries, int64 [2 n]
// (16-byte aligned: key and value pairs); overflow, int64 [4 n] (the
// overflowing partitions' tables: keys [2 n], then values [2 n]); parts,
// int64 [3 P] (partition counts, starts and cursors); lane_pos, int32
// [n_lanes]; flags, uint8 [n].
extern "C" int fpm_forward_winners_part(const void* seen, int64_t n_seen, const void* keys,
                                        const void* parents, int64_t n_lanes, int32_t log_p,
                                        int64_t table_slots, void* entries, void* overflow,
                                        void* parts_scratch, void* lane_pos, void* flags,
                                        void* win, void* stream) {
    const int64_t n = n_seen + n_lanes;
    if (n_lanes <= 0 || n_seen < 0 || n >= (int64_t(1) << 31) || log_p < 0 ||
        log_p > kMaxPartitionsLog2 || table_slots < 2 ||
        table_slots * 16 > static_cast<int64_t>(kMaxSmem) ||
        (reinterpret_cast<uintptr_t>(entries) & 15) != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int parts = 1 << log_p;
    auto* p_count = static_cast<unsigned long long*>(parts_scratch);
    unsigned long long* p_start = p_count + parts;
    unsigned long long* cursor = p_count + 2 * parts;
    auto* e = static_cast<ulonglong2*>(entries);
    auto* ovf_key = static_cast<unsigned long long*>(overflow);
    unsigned long long* ovf_val = ovf_key + 2 * n;
    auto* pos = static_cast<uint32_t*>(lane_pos);
    auto* flag = static_cast<uint8_t*>(flags);
    WinnerArgs w;
    w.seen = static_cast<const int64_t*>(seen);
    w.keys = static_cast<const int64_t*>(keys);
    w.parents = static_cast<const int32_t*>(parents);
    w.n_seen = n_seen;
    w.n_lanes = n_lanes;
    w.log_p = log_p;

    cudaError_t err = cudaMemsetAsync(p_count, 0, sizeof(unsigned long long) * parts, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
    const int64_t want_hist = grid_for(n, int64_t(kThreads) * 16);
    winner_hist_kernel<<<static_cast<int>(want_hist < cap ? want_hist : cap), kThreads,
                         sizeof(uint32_t) * parts, st>>>(w, p_count);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    winner_scan_kernel<<<1, kScanThreads, 0, st>>>(p_count, parts, p_start, cursor);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const size_t scatter_smem = (sizeof(ulonglong2) + sizeof(uint16_t)) * kScatterTile +
                                (sizeof(unsigned long long) + 2 * sizeof(uint32_t)) * parts;
    err = cudaFuncSetAttribute(winner_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(scatter_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t want_scatter = grid_for(n, kScatterTile);
    const int64_t cap_scatter = static_cast<int64_t>(sm_count()) * 2;
    winner_scatter_kernel<<<static_cast<int>(want_scatter < cap_scatter ? want_scatter
                                                                        : cap_scatter),
                            kScatterThreads, scatter_smem, st>>>(w, cursor, e, pos);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const size_t table_smem = 2 * sizeof(unsigned long long) * static_cast<size_t>(table_slots);
    err = cudaFuncSetAttribute(winner_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(table_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    winner_table_kernel<<<parts, kTableThreads, table_smem, st>>>(
        e, p_start, p_count, parts, static_cast<uint32_t>(table_slots), ovf_key, ovf_val, flag);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int64_t want_gather = grid_for(n_lanes, int64_t(kThreads) * kGatherItems);
    winner_gather_kernel<<<static_cast<int>(want_gather < cap ? want_gather : cap), kThreads, 0,
                           st>>>(pos, flag, n_lanes, static_cast<uint8_t*>(win));
    return static_cast<int>(cudaGetLastError());
}
