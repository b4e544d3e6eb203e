// Hand-written Hopper (sm_90a) kernels for the non-init LCC superstep.
//
// Both kernels replace the Pallas kernels of
// fuzzypatternmatching_tpu/ops/lcc_superstep.py. There the lookup tables
// were to be pinned in VMEM, and Mosaic refused the data-dependent gather.
// On Hopper a table gather is an ordinary indexed load, and at the R-MAT
// s21 benchmark size both tables fit in the 50 MB L2: the tv table is
// 4 bytes x (2^21 + 1) entries (8 MB) and the packed alive bits are S/8
// bytes (about 12 MB). Neither kernel needs shared memory.
//
// Plain C entry points (bound with ctypes): each launches on the stream it
// is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported to the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

int grid_for(int64_t work_items, int64_t per_block) {
    // Enough blocks to fill the card several times over; the kernels loop
    // over whatever is left (grid-stride).
    int64_t blocks = (work_items + per_block - 1) / per_block;
    const int64_t cap = 132 * 32;
    return static_cast<int>(blocks < cap ? blocks : cap);
}

// Replaces _rev_alive_kernel (fuzzypatternmatching_tpu/ops/lcc_superstep.py,
// rev_alive_lookup): out[i] = bit rev[i] of the packed alive table.
//
// Bound by streaming bytes: per slot one coalesced 4-byte read of rev, one
// 1-byte write, and one random 4-byte read of the bit table. The table is
// L2-resident at the benchmark size, so the random read costs an L2 hit,
// not a DRAM transaction. A flat grid-stride loop over the n*w slots keeps
// neighbouring threads on neighbouring slots.
__global__ void rev_alive_kernel(const int32_t* __restrict__ rev,
                                 const uint32_t* __restrict__ bits,
                                 uint8_t* __restrict__ out, int64_t count) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < count; i += stride) {
        const uint32_t r = static_cast<uint32_t>(rev[i]);
        out[i] = static_cast<uint8_t>((__ldg(bits + (r >> 5)) >> (r & 31u)) & 1u);
    }
}

// Replaces _gather_accept_kernel (fuzzypatternmatching_tpu/ops/
// lcc_superstep.py, gather_accept_or), for one ELL bucket [n, w]:
//   p = tv_table[adj]; send_ok = p != 0 && alive_rev; p = send_ok ? p : 0;
//   accept = (p & mask[row]) != 0; tn[row] = OR of accepted p over the row;
//   sendok[row] = number of send_ok slots in the row.
//
// Bound by streaming bytes (adj 4 B + alive_rev 1 B read, accept 1 B
// written per slot) plus one random tv_table read per slot, which hits L2.
// One warp per row: the lanes walk the row in strides of 32, so the adj,
// alive_rev and accept accesses are coalesced, and the row reductions are
// single warp instructions (__reduce_or_sync / __reduce_add_sync) with no
// shared memory. Narrow buckets (w = 8) leave most lanes idle; every width
// from 8 to 8192 is handled by the same loop.
__global__ void gather_accept_kernel(const int32_t* __restrict__ adj,
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
        const int32_t m = mask[row];
        const int64_t base = row * w;
        uint32_t tn_acc = 0;
        uint32_t count = 0;
        for (int32_t j = lane; j < w; j += 32) {
            const int64_t s = base + j;
            int32_t p = __ldg(tv_table + adj[s]);
            const bool ok = (p != 0) && (alive_rev[s] != 0);
            p = ok ? p : 0;
            const bool acc = (p & m) != 0;
            accept[s] = static_cast<uint8_t>(acc);
            tn_acc |= acc ? static_cast<uint32_t>(p) : 0u;
            count += ok ? 1u : 0u;
        }
        tn_acc = __reduce_or_sync(0xffffffffu, tn_acc);
        count = __reduce_add_sync(0xffffffffu, count);
        if (lane == 0) {
            tn[row] = static_cast<int32_t>(tn_acc);
            sendok[row] = static_cast<int32_t>(count);
        }
    }
}

}  // namespace

extern "C" int fpm_rev_alive_lookup(const void* rev, const void* bits,
                                    void* out, int64_t count, void* stream) {
    if (count > 0) {
        rev_alive_kernel<<<grid_for(count, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(rev), static_cast<const uint32_t*>(bits),
            static_cast<uint8_t*>(out), count);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int fpm_gather_accept_or(const void* adj, const void* alive_rev,
                                    const void* mask, const void* tv_table,
                                    void* tn, void* accept, void* sendok,
                                    int64_t n, int32_t w, void* stream) {
    if (n > 0) {
        gather_accept_kernel<<<grid_for(n, kThreads / 32), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(adj),
            static_cast<const uint8_t*>(alive_rev),
            static_cast<const int32_t*>(mask),
            static_cast<const int32_t*>(tv_table), static_cast<int32_t*>(tn),
            static_cast<uint8_t*>(accept), static_cast<int32_t*>(sendok), n, w);
    }
    return static_cast<int>(cudaGetLastError());
}
