// Hand-written Hopper (sm_90a) kernels for the non-init LCC superstep.
//
// They replace the Pallas kernels of fuzzypatternmatching_tpu/ops/
// lcc_superstep.py, and the jnp.sum there that packs the alive flags.
// There the lookup tables were to be pinned in VMEM. On Hopper a table
// gather is an ordinary indexed load, and at the R-MAT s21 benchmark size
// both tables fit in the 50 MB L2: the tv table is 4 bytes x (2^21 + 1)
// entries (8 MB) and the packed alive bits are S/8 bytes (about 11 MB).
// What limits a gather is not DRAM but the random 32-byte L2 sectors it
// touches, one per slot. After the init superstep almost every alive flag
// is zero, so the kernels skip the gathers whose answer is known to be 0:
//
//   * pack_alive builds, in one pass over the flags, the packed words and
//     a group summary: one bit per group of G = 2^group_log2 slots, set
//     where any flag of the group is set. G is chosen (by the caller) so
//     that the summary fits in kMaxSummaryBytes of shared memory.
//   * rev_alive_lookup stages the summary in shared memory and reads a
//     word from L2 only where the slot's group has an alive bit.
//   * gather_accept_or reads adj and the tv table only where alive_rev is
//     set; elsewhere the slot's outputs are zero by definition.
//
// Plain C entry points (bound with ctypes): each launches on the stream it
// is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported to the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// Shared-memory budget of the group summary; ops/lcc_superstep.py
// (SUMMARY_BUDGET_BYTES) chooses G against the same number.
constexpr int kMaxSummaryBytes = 96 * 1024;
constexpr int kLookupThreads = 1024;

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
    // Enough blocks to fill the card several times over; the kernels loop
    // over whatever is left (grid-stride).
    int64_t blocks = (work_items + per_block - 1) / per_block;
    const int64_t cap = static_cast<int64_t>(sm_count()) * 32;
    return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

bool aligned(const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// ---------------------------------------------------------------------------
// pack_alive: flags -> packed words + group summary.
//
// Replaces the packing in pack_alive (fuzzypatternmatching_tpu/ops/
// lcc_superstep.py, a jnp.sum over weighted flags, not a Pallas kernel).
// Bound by bytes: each flag byte is read once (16-byte evict-first loads),
// each word and summary word written once: N + N/8 bytes.
//
// One warp builds one summary word, i.e. 32 groups = 32*G flags, in chunks
// of 512 flags: each lane loads 16 flags with one 16-byte load and turns
// them into a 16-bit mask in registers; an even lane joins its mask with
// its odd neighbour's (one shuffle) into a 32-bit word and stores it. A
// lane's 16 flags lie in one group (G >= 32), so the lane ORs its group's
// bit into a register and one warp OR gives the summary word: no atomics,
// no memset, and words of groups past the end are written as zero.

__device__ __forceinline__ uint32_t nibble(uint32_t x) {
    // four 0/1 bytes -> four bits
    return (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
}

template <bool kVec>
__device__ __forceinline__ uint32_t mask16(const uint8_t* __restrict__ flags,
                                           int64_t first, int64_t n) {
    if (kVec && first + 16 <= n) {
        const uint4 v = __ldcs(reinterpret_cast<const uint4*>(flags + first));
        return nibble(v.x) | (nibble(v.y) << 4) | (nibble(v.z) << 8) |
               (nibble(v.w) << 12);
    }
    uint32_t m = 0;
    for (int k = 0; k < 16; ++k) {
        if (first + k < n && flags[first + k] != 0) m |= 1u << k;
    }
    return m;
}

template <bool kVec>
__global__ void pack_alive_kernel(const uint8_t* __restrict__ flags, int64_t n,
                                  uint32_t* __restrict__ words, int64_t n_words,
                                  uint32_t* __restrict__ summary,
                                  int64_t summary_words, int group_log2) {
    constexpr int kBatch = 4;  // 512-flag chunks loaded before any is used
    const unsigned lane = threadIdx.x & 31u;
    const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
    const int64_t unit = int64_t(32) << group_log2;  // flags per summary word
    const int chunks = static_cast<int>(unit >> 9);   // >= 2
    for (int64_t u = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
         u < summary_words; u += n_warps) {
        const int64_t base = u * unit;
        uint32_t sbits = 0;
        for (int c0 = 0; c0 < chunks; c0 += kBatch) {
            uint32_t m[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const int64_t first = base + (int64_t(c0 + k) << 9) + lane * 16;
                m[k] = (c0 + k < chunks && first < n) ? mask16<kVec>(flags, first, n) : 0u;
            }
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                if (c0 + k >= chunks) break;  // warp-uniform
                const int64_t off = (int64_t(c0 + k) << 9) + lane * 16;
                sbits |= m[k] != 0 ? 1u << static_cast<int>(off >> group_log2) : 0u;
                const uint32_t hi = __shfl_down_sync(kFull, m[k], 1);
                const int64_t wi = (base + off) >> 5;
                if ((lane & 1u) == 0 && wi < n_words) words[wi] = m[k] | (hi << 16);
            }
        }
        sbits = __reduce_or_sync(kFull, sbits);
        if (lane == 0) summary[u] = sbits;
    }
}

// ---------------------------------------------------------------------------
// rev_alive_lookup: out[i] = alive bit rev[i], through the group summary.
//
// Replaces _rev_alive_kernel (fuzzypatternmatching_tpu/ops/lcc_superstep.py,
// rev_alive_lookup). Bound by bytes at best: per slot a 4-byte rev read
// and a 1-byte write, streamed. What held the plain lookup back was one
// random L2 sector per slot. Here a slot first tests its group's bit in
// the shared-memory summary and reads the word from L2 only where the bit
// is set (after the init superstep, a few per cent of the slots).
//
// Each block stages the summary once with a 1-D TMA bulk copy
// (cp.async.bulk, completion on an mbarrier) and then walks a grid-stride
// range of the flat slot space: one launch covers every bucket, and the
// grid is a few blocks per SM so that staging stays a small share of the
// rev stream. Each thread takes 8 slots per step as two 16-byte loads of
// rev (evict-first, so the stream does not push the tables out of L2) and
// stores the 8 flags as two 4-byte words.

__device__ __forceinline__ void stage_to_shared(void* dst, const void* src,
                                                uint32_t bytes, uint64_t* bar) {
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

__device__ __forceinline__ uint32_t lookup(int32_t r, const uint32_t* s_sum,
                                           const uint32_t* __restrict__ words,
                                           int group_log2) {
    const uint32_t ur = static_cast<uint32_t>(r);
    const uint32_t g = ur >> group_log2;
    if (((s_sum[g >> 5] >> (g & 31u)) & 1u) == 0) return 0u;
    return (__ldg(words + (ur >> 5)) >> (ur & 31u)) & 1u;
}

__device__ __forceinline__ uint32_t lookup4(int4 r, const uint32_t* s_sum,
                                            const uint32_t* __restrict__ words,
                                            int group_log2) {
    return lookup(r.x, s_sum, words, group_log2) |
           (lookup(r.y, s_sum, words, group_log2) << 8) |
           (lookup(r.z, s_sum, words, group_log2) << 16) |
           (lookup(r.w, s_sum, words, group_log2) << 24);
}

template <bool kVec>
__global__ void __launch_bounds__(kLookupThreads, 2)
rev_alive_kernel(const int32_t* __restrict__ rev,
                 const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ summary, uint32_t summary_bytes,
                 int group_log2, uint8_t* __restrict__ out, int64_t count) {
    extern __shared__ __align__(128) uint32_t s_sum[];
    __shared__ __align__(8) uint64_t bar;
    stage_to_shared(s_sum, summary, summary_bytes, &bar);

    const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    int64_t done = 0;
    if (kVec) {
        const int4* rev4 = reinterpret_cast<const int4*>(rev);
        uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
        const int64_t n4 = count >> 2;
        int64_t i = tid;
        for (; i + stride < n4; i += 2 * stride) {
            const int4 a = __ldcs(rev4 + i);
            const int4 b = __ldcs(rev4 + i + stride);
            __stcs(out4 + i, lookup4(a, s_sum, words, group_log2));
            __stcs(out4 + i + stride, lookup4(b, s_sum, words, group_log2));
        }
        if (i < n4) __stcs(out4 + i, lookup4(__ldcs(rev4 + i), s_sum, words, group_log2));
        done = n4 << 2;
    }
    for (int64_t i = done + tid; i < count; i += stride) {
        out[i] = static_cast<uint8_t>(lookup(__ldcs(rev + i), s_sum, words, group_log2));
    }
}

// ---------------------------------------------------------------------------
// gather_accept_or, for one ELL bucket [n, w]:
//   p = tv_table[adj]; send_ok = p != 0 && alive_rev; p = send_ok ? p : 0;
//   accept = (p & mask[row]) != 0; tn[row] = OR of accepted p over the row;
//   sendok[row] = number of send_ok slots in the row.
//
// Replaces _gather_accept_kernel (fuzzypatternmatching_tpu/ops/
// lcc_superstep.py, gather_accept_or). Bound by bytes: per slot 1 byte of
// alive_rev read and 1 byte of accept written, 12 bytes per row, and adj
// plus a tv entry only for the slots whose alive_rev is set. Both the adj
// load and the tv load are predicated on alive_rev, which is exact: a slot
// with alive_rev = 0 has p = 0, accept = 0 and adds nothing to tn or
// sendok. So only the sectors of lanes with work are fetched, and the
// random tv reads fall with the alive set.
//
// Lanes map to rows by width (planes aligned for the vector accesses; any
// other case takes the one-slot-per-lane kernels):
//   * 4 <= w <= 64: a lane takes 4 consecutive slots (one 4-byte alive_rev
//     load, a 16-byte adj load only where a flag is set, one 4-byte accept
//     store), a row takes w/4 lanes and a warp 128/w rows, with OR/add
//     reductions over the row's lanes (xor-shuffles). Every lane takes part
//     in the shuffles; lanes past the last row carry zeros, so the ragged
//     last warp needs no masks. Two 128-slot chunks are loaded per warp
//     before either is used.
//   * w a multiple of 128: a lane takes 4 consecutive slots (w < 512) or 16
//     (w a multiple of 512: one 16-byte alive_rev load and store), a row
//     takes 1, 2, 4 or 8 warps (partial results meet in shared memory), and
//     two steps are loaded before either is used.
//   * otherwise (off the engine's path: other widths, unaligned planes): a
//     warp per row, its lanes striding 32 slots.

struct RowAcc {
    uint32_t tn = 0;
    uint32_t count = 0;
};

__device__ __forceinline__ uint32_t slot(int32_t a, const int32_t* __restrict__ tv_table,
                                         uint32_t m, RowAcc& acc) {
    const uint32_t p = static_cast<uint32_t>(__ldg(tv_table + a));
    if (p == 0) return 0u;
    acc.count += 1;
    if ((p & m) == 0) return 0u;
    acc.tn |= p;
    return 1u;
}

// 4 slots s..s+3 whose alive_rev bytes are f: accept bytes of the 4 slots
__device__ __forceinline__ uint32_t slots4(const int32_t* __restrict__ adj, int64_t s,
                                           uint32_t f,
                                           const int32_t* __restrict__ tv_table,
                                           uint32_t m, RowAcc& acc) {
    if (f == 0) return 0u;
    const int4 a = __ldcs(reinterpret_cast<const int4*>(adj + s));
    uint32_t out = 0;
    if (f & 0x000000ffu) out |= slot(a.x, tv_table, m, acc);
    if (f & 0x0000ff00u) out |= slot(a.y, tv_table, m, acc) << 8;
    if (f & 0x00ff0000u) out |= slot(a.z, tv_table, m, acc) << 16;
    if (f & 0xff000000u) out |= slot(a.w, tv_table, m, acc) << 24;
    return out;
}

// V consecutive slots per lane: the alive_rev load, the gated work and the
// accept store of one lane's step
template <int V>
struct Lane;

template <>
struct Lane<4> {
    using F = uint32_t;
    static __device__ __forceinline__ F load(const uint8_t* p, int64_t s) {
        return __ldcs(reinterpret_cast<const uint32_t*>(p + s));
    }
    static __device__ __forceinline__ void store(uint8_t* p, int64_t s, F v) {
        __stcs(reinterpret_cast<uint32_t*>(p + s), v);
    }
    static __device__ __forceinline__ F run(const int32_t* __restrict__ adj, int64_t s,
                                            F f, const int32_t* __restrict__ tv,
                                            uint32_t m, RowAcc& acc) {
        return slots4(adj, s, f, tv, m, acc);
    }
};

template <>
struct Lane<16> {
    using F = uint4;
    static __device__ __forceinline__ F load(const uint8_t* p, int64_t s) {
        return __ldcs(reinterpret_cast<const uint4*>(p + s));
    }
    static __device__ __forceinline__ void store(uint8_t* p, int64_t s, F v) {
        __stcs(reinterpret_cast<uint4*>(p + s), v);
    }
    static __device__ __forceinline__ F run(const int32_t* __restrict__ adj, int64_t s,
                                            F f, const int32_t* __restrict__ tv,
                                            uint32_t m, RowAcc& acc) {
        return make_uint4(slots4(adj, s, f.x, tv, m, acc),
                          slots4(adj, s + 4, f.y, tv, m, acc),
                          slots4(adj, s + 8, f.z, tv, m, acc),
                          slots4(adj, s + 12, f.w, tv, m, acc));
    }
};

__device__ __forceinline__ void store_row(int32_t* __restrict__ tn,
                                          int32_t* __restrict__ sendok, int64_t row,
                                          const RowAcc& acc) {
    tn[row] = static_cast<int32_t>(acc.tn);
    sendok[row] = static_cast<int32_t>(acc.count);
}

// One 128-slot chunk of the 4 <= w <= 64 kernel: lane's slots s..s+3.
__device__ __forceinline__ void narrow4_chunk(const int32_t* __restrict__ adj,
                                              const int32_t* __restrict__ mask,
                                              const int32_t* __restrict__ tv_table,
                                              int32_t* __restrict__ tn,
                                              uint8_t* __restrict__ accept,
                                              int32_t* __restrict__ sendok,
                                              int64_t s, uint32_t f, int64_t total,
                                              int w_log2) {
    const int64_t row = s >> w_log2;
    RowAcc acc;
    if (s < total) {
        const uint32_t m = f != 0 ? static_cast<uint32_t>(mask[row]) : 0u;
        Lane<4>::store(accept, s, slots4(adj, s, f, tv_table, m, acc));
    }
    for (int off = (1 << w_log2) >> 3; off > 0; off >>= 1) {  // w/4 lanes
        acc.tn |= __shfl_xor_sync(kFull, acc.tn, off);
        acc.count += __shfl_xor_sync(kFull, acc.count, off);
    }
    if (s < total && (s & ((int64_t(1) << w_log2) - 1)) == 0) store_row(tn, sendok, row, acc);
}

__global__ void gather_narrow4_kernel(const int32_t* __restrict__ adj,
                                      const uint8_t* __restrict__ alive_rev,
                                      const int32_t* __restrict__ mask,
                                      const int32_t* __restrict__ tv_table,
                                      int32_t* __restrict__ tn,
                                      uint8_t* __restrict__ accept,
                                      int32_t* __restrict__ sendok,
                                      int64_t n, int w_log2) {
    const unsigned lane = threadIdx.x & 31u;
    const int64_t total = n << w_log2;  // a multiple of 4
    const int64_t chunks = (total + 127) >> 7;
    const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
    for (int64_t c = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
         c < chunks; c += 2 * warps) {
        const int64_t s0 = (c << 7) + lane * 4;
        const int64_t s1 = s0 + (warps << 7);
        const uint32_t f0 = s0 < total ? Lane<4>::load(alive_rev, s0) : 0u;
        const uint32_t f1 = s1 < total ? Lane<4>::load(alive_rev, s1) : 0u;
        narrow4_chunk(adj, mask, tv_table, tn, accept, sendok, s0, f0, total, w_log2);
        narrow4_chunk(adj, mask, tv_table, tn, accept, sendok, s1, f1, total, w_log2);
    }
}

template <int V>
__global__ void gather_wide_kernel(const int32_t* __restrict__ adj,
                                   const uint8_t* __restrict__ alive_rev,
                                   const int32_t* __restrict__ mask,
                                   const int32_t* __restrict__ tv_table,
                                   int32_t* __restrict__ tn,
                                   uint8_t* __restrict__ accept,
                                   int32_t* __restrict__ sendok,
                                   int64_t n, int32_t w, int warps_per_row) {
    using L = Lane<V>;
    __shared__ uint32_t s_tn[kThreads / 32];
    __shared__ uint32_t s_count[kThreads / 32];
    const unsigned lane = threadIdx.x & 31u;
    const int warp = static_cast<int>(threadIdx.x >> 5);
    const int rows_per_block = (kThreads / 32) / warps_per_row;
    const int sub = warp % warps_per_row;  // warp within its row's group
    const int group = warp / warps_per_row;  // row within the block
    const int32_t span = warps_per_row * 32 * V;  // slots per step of a group
    // block-uniform loop: every thread reaches the __syncthreads below
    for (int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block; first < n;
         first += static_cast<int64_t>(gridDim.x) * rows_per_block) {
        const int64_t row = first + group;
        RowAcc acc;
        if (row < n) {
            const uint32_t m = static_cast<uint32_t>(mask[row]);
            const int64_t base = row * w;
            int32_t j = (sub * 32 + static_cast<int32_t>(lane)) * V;
            for (; j + span < w; j += 2 * span) {
                const int64_t s0 = base + j, s1 = s0 + span;
                const typename L::F f0 = L::load(alive_rev, s0);
                const typename L::F f1 = L::load(alive_rev, s1);
                L::store(accept, s0, L::run(adj, s0, f0, tv_table, m, acc));
                L::store(accept, s1, L::run(adj, s1, f1, tv_table, m, acc));
            }
            if (j < w) {
                const int64_t s0 = base + j;
                L::store(accept, s0, L::run(adj, s0, L::load(alive_rev, s0), tv_table, m, acc));
            }
        }
        acc.tn = __reduce_or_sync(kFull, acc.tn);
        acc.count = __reduce_add_sync(kFull, acc.count);
        if (warps_per_row == 1) {
            if (lane == 0 && row < n) store_row(tn, sendok, row, acc);
            continue;
        }
        if (lane == 0) {
            s_tn[warp] = acc.tn;
            s_count[warp] = acc.count;
        }
        __syncthreads();
        if (sub == 0 && lane == 0 && row < n) {
            RowAcc total;
            for (int k = 0; k < warps_per_row; ++k) {
                total.tn |= s_tn[warp + k];
                total.count += s_count[warp + k];
            }
            store_row(tn, sendok, row, total);
        }
        __syncthreads();
    }
}

__global__ void gather_rowwise_kernel(const int32_t* __restrict__ adj,
                                      const uint8_t* __restrict__ alive_rev,
                                      const int32_t* __restrict__ mask,
                                      const int32_t* __restrict__ tv_table,
                                      int32_t* __restrict__ tn,
                                      uint8_t* __restrict__ accept,
                                      int32_t* __restrict__ sendok,
                                      int64_t n, int32_t w) {
    const unsigned lane = threadIdx.x & 31u;
    const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
    for (int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
         row < n; row += warps) {
        const uint32_t m = static_cast<uint32_t>(mask[row]);
        const int64_t base = row * w;
        RowAcc acc;
        for (int32_t j = lane; j < w; j += 32) {
            const int64_t s = base + j;
            uint32_t a = 0;
            if (alive_rev[s] != 0) a = slot(adj[s], tv_table, m, acc);
            accept[s] = static_cast<uint8_t>(a);
        }
        acc.tn = __reduce_or_sync(kFull, acc.tn);
        acc.count = __reduce_add_sync(kFull, acc.count);
        if (lane == 0) store_row(tn, sendok, row, acc);
    }
}

}  // namespace

extern "C" int fpm_pack_alive(const void* flags, int64_t n, void* words,
                              int64_t n_words, void* summary,
                              int64_t summary_words, int32_t group_log2,
                              void* stream) {
    if (group_log2 < 5 || group_log2 > 30 || summary_words <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int blocks = grid_for(summary_words, kThreads / 32);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* f = static_cast<const uint8_t*>(flags);
    auto* wd = static_cast<uint32_t*>(words);
    auto* sm = static_cast<uint32_t*>(summary);
    if (aligned(flags, 16)) {
        pack_alive_kernel<true><<<blocks, kThreads, 0, st>>>(
            f, n, wd, n_words, sm, summary_words, group_log2);
    } else {
        pack_alive_kernel<false><<<blocks, kThreads, 0, st>>>(
            f, n, wd, n_words, sm, summary_words, group_log2);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int fpm_rev_alive_lookup(const void* rev, const void* words,
                                    const void* summary, int64_t summary_words,
                                    int32_t group_log2, void* out, int64_t count,
                                    void* stream) {
    const int64_t bytes = summary_words * 4;
    if (bytes <= 0 || bytes > kMaxSummaryBytes || (bytes & 15) != 0 ||
        !aligned(summary, 16) || group_log2 < 5 || group_log2 > 30) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (count <= 0) return static_cast<int>(cudaGetLastError());
    const bool vec = aligned(rev, 16) && aligned(out, 4);
    auto kernel = vec ? rev_alive_kernel<true> : rev_alive_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSummaryBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kLookupThreads, static_cast<size_t>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
    const int64_t want = (count + int64_t(kLookupThreads) * 8 - 1) / (int64_t(kLookupThreads) * 8);
    const int64_t cap = static_cast<int64_t>(sm_count()) * per_sm;
    const int blocks = static_cast<int>(want < cap ? want : cap);
    kernel<<<blocks, kLookupThreads, static_cast<size_t>(bytes),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rev), static_cast<const uint32_t*>(words),
        static_cast<const uint32_t*>(summary), static_cast<uint32_t>(bytes),
        group_log2, static_cast<uint8_t*>(out), count);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int fpm_gather_accept_or(const void* adj, const void* alive_rev,
                                    const void* mask, const void* tv_table,
                                    void* tn, void* accept, void* sendok,
                                    int64_t n, int32_t w, void* stream) {
    if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* a = static_cast<const int32_t*>(adj);
    auto* ar = static_cast<const uint8_t*>(alive_rev);
    auto* m = static_cast<const int32_t*>(mask);
    auto* t = static_cast<const int32_t*>(tv_table);
    auto* o_tn = static_cast<int32_t*>(tn);
    auto* o_acc = static_cast<uint8_t*>(accept);
    auto* o_cnt = static_cast<int32_t*>(sendok);
    const bool pow2 = (w & (w - 1)) == 0;
    int w_log2 = 0;
    while ((1 << w_log2) < w) ++w_log2;
    const bool vec4 = aligned(adj, 16) && aligned(alive_rev, 4) && aligned(accept, 4);
    const bool vec16 = aligned(adj, 16) && aligned(alive_rev, 16) && aligned(accept, 16);
    if (pow2 && w >= 4 && w <= 64 && vec4) {
        gather_narrow4_kernel<<<grid_for((n * w + 127) / 128, kThreads / 32), kThreads, 0,
                                st>>>(a, ar, m, t, o_tn, o_acc, o_cnt, n, w_log2);
    } else if (w % 512 == 0 && vec16) {
        // 16 slots per lane; a row takes about w / 1024 warps (1..8), so
        // that each lane has two steps in flight
        const int warps_per_row = w >= 8192 ? 8 : w >= 4096 ? 4 : w >= 2048 ? 2 : 1;
        gather_wide_kernel<16><<<grid_for(n, (kThreads / 32) / warps_per_row), kThreads,
                                 0, st>>>(a, ar, m, t, o_tn, o_acc, o_cnt, n, w,
                                          warps_per_row);
    } else if (w % 128 == 0 && vec4) {
        gather_wide_kernel<4><<<grid_for(n, kThreads / 32), kThreads, 0, st>>>(
            a, ar, m, t, o_tn, o_acc, o_cnt, n, w, 1);
    } else {
        gather_rowwise_kernel<<<grid_for(n, kThreads / 32), kThreads, 0, st>>>(
            a, ar, m, t, o_tn, o_acc, o_cnt, n, w);
    }
    return static_cast<int>(cudaGetLastError());
}
