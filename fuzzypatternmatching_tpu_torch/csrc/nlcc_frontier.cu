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
// from col (contiguous within a row) and, where it is a message, a random
// 4-byte entry of the ok_bits table; a survivor writes 8 bytes. After the
// first hop most lanes fail the arrival test (at R-MAT s21, hop 3 of the
// cycle corpus keeps 2 % of 74 M lanes), so the col stream and the random
// ok_bits sectors are the cost. Load balance: rows are ragged (R-MAT hubs
// hold tens of thousands of neighbours), so the lanes, not the tokens,
// are split: a warp takes a fixed chunk of kChunk consecutive lanes of the
// flattened expansion (a merge-path split) and finds the token of each lane
// by a binary search of the inclusive lane offsets, narrowed to the
// chunk's token range. A hub row is cut into many chunks; many short rows
// share one. Two passes keep the output exact and in lane order: pass 1
// counts the survivors of each chunk (and the messages, per receiving
// rank); the wrapper's cumsum gives each chunk its output offset; pass 2
// walks the chunk again and writes its survivors, placed by a warp ballot.
//
// forward_winners. A lane wins iff its key (v * V + src) was not forwarded
// before and its parent is the smallest among the lanes of that key, ties
// going to the earlier lane: exactly the stable sort by (key, parent) of
// the JAX package and the host engine's lexsort. Bound by bytes: keys,
// parents and the earlier keys read once, the flags written once; the
// random accesses go to an open-addressing hash table sized to at least
// twice the keys it holds (it cannot fill). Pass 1 inserts every earlier
// key with value 0 and every lane's key with value (parent + 1) << 32 |
// lane, keeping the minimum with a 64-bit atomicMin; pass 2 marks a lane a
// winner iff the slot of its key holds its own value. The minimum does not
// depend on the order of the atomics, so the result is deterministic.
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
// Lanes of the flattened expansion per warp: 8 rounds of 32. Must equal
// EXPAND_CHUNK in ops/nlcc_frontier.py.
constexpr int64_t kChunk = 256;
// Per-rank message counters live in shared memory up to this many ranks,
// and go straight to global atomics above it.
constexpr int kMaxSharedRanks = 4096;
constexpr unsigned long long kEmpty = ~0ull;

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

// ---------------------------------------------------------------------------
// expand_frontier

struct ExpandArgs {
    const int64_t* __restrict__ ptr;       // [V + 1] alive CSR offsets
    const int32_t* __restrict__ col;       // [A] alive CSR neighbours
    const int32_t* __restrict__ cur;       // [F] token vertices
    const int32_t* __restrict__ parent;    // [F] vertex each token came from
    const int64_t* __restrict__ lane_end;  // [F] inclusive lane offsets
    const uint32_t* __restrict__ ok_bits;  // [V] arrival bits per vertex
    int64_t n_tok;
    int64_t lanes;
    int h_next;
    int num_ranks;
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
                if (msg) {
                    if (a.num_ranks == 1) {
                        ++msgs;
                    } else if (shared_ranks) {
                        atomicAdd(&s_msg[nbr % a.num_ranks], 1ull);
                    } else {
                        atomicAdd(msg_per_rank + nbr % a.num_ranks, 1ull);
                    }
                }
            }
            kept += __popc(__ballot_sync(kFull, keep));
        }
        if (lane == 0) chunk_count[chunk] = static_cast<int32_t>(kept);
    }
    if (a.num_ranks == 1) {
        msgs = __reduce_add_sync(kFull, msgs);
        if (lane == 0 && msgs != 0) atomicAdd(msg_per_rank, static_cast<unsigned long long>(msgs));
    } else if (shared_ranks) {
        __syncthreads();
        for (int r = threadIdx.x; r < a.num_ranks; r += blockDim.x) {
            if (s_msg[r] != 0) atomicAdd(msg_per_rank + r, s_msg[r]);
        }
    }
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

ExpandArgs expand_args(const void* ptr, const void* col, const void* cur, const void* parent,
                       const void* lane_end, int64_t n_tok, int64_t lanes, const void* ok_bits,
                       int32_t h_next, int32_t num_ranks) {
    ExpandArgs a;
    a.ptr = static_cast<const int64_t*>(ptr);
    a.col = static_cast<const int32_t*>(col);
    a.cur = static_cast<const int32_t*>(cur);
    a.parent = static_cast<const int32_t*>(parent);
    a.lane_end = static_cast<const int64_t*>(lane_end);
    a.ok_bits = static_cast<const uint32_t*>(ok_bits);
    a.n_tok = n_tok;
    a.lanes = lanes;
    a.h_next = h_next;
    a.num_ranks = num_ranks;
    return a;
}

bool bad_expand_args(int64_t n_tok, int64_t lanes, int32_t h_next, int32_t num_ranks) {
    return n_tok <= 0 || lanes <= 0 || h_next < -1 || h_next > 30 || num_ranks < 1;
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

// Winner flags (uint8 [n_lanes]) of one nem hop. t_keys and t_vals are
// [capacity] 64-bit words filled with all ones by the caller; capacity is a
// power of two above n_seen + n_lanes.
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
