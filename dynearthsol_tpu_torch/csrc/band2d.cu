// Corner gather and nodal assembly on unstructured meshes, for Hopper
// (sm_90a).
//
// Replaces the three Pallas kernels of dynearthsol_tpu/ops/band2d.py:
//   des_gather_corners          <- gather_corners_tpu         (pallas_call :663)
//   des_scatter_corners         <- scatter_corners_tpu        (pallas_call :795)
//   des_scatter_gather_corners  <- scatter_gather_corners_tpu (pallas_call :519)
// Plain PyTorch versions: ops/band2d.py gather_corners, scatter_corners,
// scatter_gather_corners.
//
// The TPU kernels pack nodes into supernode rows, fetch a window of rows per
// element block and select with one-hot matmuls, because a TPU gathers
// slowly and multiplies fast.  Nothing of that is kept.
//
// What bounds them on this card: memory traffic, and within it the random
// reads.  No arithmetic but the sums.  A gather of k fields reads the
// (nnode, k) pack and the corner table and writes npe * k element columns;
// an assembly reads npe * k element columns and the CSR support and writes
// (nnode, k) sums.  Every element value is read once by the assembly (each
// slot belongs to one node): a permutation, whose cost is the random reads.
// The mesh generator numbers nodes and elements along the longest axis, so
// the slots of a node's neighbours lie hundreds of element ids apart and
// most 32-byte sectors serve one value per request; what a kernel can do
// is keep enough of those requests in flight.
//
// The gather (gather_corners_kernel): blocks of GTHREADS threads, one block
// per tile of TILE consecutive elements.  The corners of a tile lie within
// a short range of node ids (its window: some 1,000 rows for 1,024
// elements of the 277k-triangle mesh, as the generator numbers nodes and
// elements along x), but at random within it, so one thread per slot paid
// a 32-byte sector per 4-byte read, some 20 times the bytes of the data.
// A staged tile (window at most WMAX rows; the tables decide) copies its
// window's rows, all ld columns, into shared memory with one
// cp.async.bulk that completes on an mbarrier; each thread then takes
// elements of the tile and reads their corners from shared memory
// through the slot's id relative to the window (int16, half the int32
// table), and writes out[j, c, e] coalesced.  A wider tile reads the pack
// directly, one thread per element.  The values are copied as 4- or
// 8-byte words, never as floats: the result is the plain version's bit
// for bit, signed zeros and NaN payloads included.  One dynamic shared
// memory size serves the launch: the widest staged window.
//
// The assembly (asm_pack_kernel): one thread per node, k (1-8) a template
// parameter.  The thread loads its row's first UNROLL slot ids, then all k
// x UNROLL values at once -- independent loads, no chain from one slot to
// the next -- and adds each field's values in row order, from +0.0, in
// registers: no atomics, so the result equals ops/assembly.node_sum's bit
// for bit and is the same on every run.  UNROLL = 12 covers every node of
// a Delaunay mesh refined to a 30-degree minimum angle (the flagship's 32
// degrees give at most 9); a longer row (the 5-tet grid reaches 32) adds
// the rest one slot after the other.  Index arithmetic is 32-bit
// (ops/band2d.build_tables refuses meshes of 2^31 / KMAX slots).  128
// threads a block, no shared memory.  A node block staging its slots'
// values in shared memory, and one thread per (node, field), were each
// slower at the flat step's k (tools/band2d_forms.cu; PERF.md, findings
// on kernels 4 and 6).
//
// Layouts (ops/band2d.py): nodal packs (nnode, k) row-major; element packs
// (k, npe, nelem), slot = corner * nelem + e; conn_cm (npe * nelem) the
// node of each slot, rel_cm the same less its tile's window base;
// tile_lo/tile_w/tile_staged per tile; row_ptr/slots the node -> slot
// support as CSR in the order of ops/assembly.node_sum.  -fmad=false
// changes nothing here (there is no multiply) but the file is built with
// the others.
//
// des_scatter_gather_corners needs every nodal sum complete before any
// corner reads it, a grid-wide dependency: it is two launches on one
// stream behind one entry point (the assembly, then a gather of the first
// kg columns of the sums, staging whole rows of k).  One cooperative
// launch with a grid sync between the two, and one launch in which each
// node's thread writes its sums to its own corner slots, were each slower
// (same place).

#include <cuda_runtime.h>

namespace {

constexpr int GTHREADS = 256;     // threads of a gather block
constexpr int TILE = 1024;        // elements of a gather tile (ops/band2d.py)
constexpr int WMAX = 2048;        // rows of the widest staged window
constexpr int KMAX = 8;
constexpr int ASM_THREADS = 128;  // nodes (threads) of an assembly block
constexpr int UNROLL = 12;        // slots of a row loaded at once

// ---- the bulk copy into shared memory and its mbarrier (sm_90)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: arrive on bar expecting `bytes`, and copy `bytes` (a
// multiple of 16; both addresses 16-byte aligned) from src to dst.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of bar with the given parity to complete.  A copy
// that never lands (a fault) traps after a second rather than hang the
// card; the error surfaces at the caller's next synchronisation.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  const unsigned long long t0 = global_ns();
  for (;;) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - t0 > 1000000000ull) __trap();
  }
}

// ---- the gather

constexpr int EPT = TILE / GTHREADS;  // elements of a tile a thread takes

// out[j, c * nelem + e] = from[id[i][c] * ld + j] for the thread's
// elements e = e0 + i * GTHREADS + threadIdx.x, j < K; `from` the staged
// window or the pack.
template <typename U, int K, int E = EPT>
__device__ __forceinline__ void put_corners(const U* from, int ld,
                                            const int (&id)[E][4], int npe,
                                            int nelem, int e0,
                                            U* __restrict__ out) {
  const int ns = npe * nelem;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = e0 + i * GTHREADS + threadIdx.x;
    if (e >= nelem) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= npe) break;
      const U* row = from + id[i][c] * ld;
      U v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = row[j];
#pragma unroll
      for (int j = 0; j < K; ++j) out[j * ns + c * nelem + e] = v[j];
    }
  }
}

// out[j, s] = pack[conn_cm[s], j] for j < K (pack rows are ld >= K apart),
// as words U of the value's size; one block per tile of TILE elements.
// The slots' ids are loaded while the window is in flight.
template <typename U, int K>
__global__ void __launch_bounds__(GTHREADS)
    gather_corners_kernel(const U* __restrict__ pack, int ld,
                          const int* __restrict__ conn_cm,
                          const short* __restrict__ rel_cm,
                          const int* __restrict__ tile_lo,
                          const int* __restrict__ tile_w,
                          const unsigned char* __restrict__ tile_staged,
                          int npe, int nelem, U* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  U* win = reinterpret_cast<U*>(smem);
  const int t = blockIdx.x, e0 = t * TILE;
  const bool staged = tile_staged[t];
  const U* src = pack + (long long)tile_lo[t] * ld;
  const int n = staged ? tile_w[t] * ld : 0;                // words
  const unsigned bulk = (n * (unsigned)sizeof(U)) & ~15u;  // bytes
  if (staged && threadIdx.x == 0) {
    bar_init(&bar);
    bulk_load(win, src, bulk, &bar);
  }
  int id[EPT][4];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = e0 + i * GTHREADS + threadIdx.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = c * nelem + e;
      id[i][c] = e >= nelem || c >= npe ? 0
                 : staged               ? (unsigned short)rel_cm[s]
                                        : conn_cm[s];
    }
  }
  if (!staged) {
    put_corners<U, K>(pack, ld, id, npe, nelem, e0, out);
    return;
  }
  // the window's last < 16 bytes, which the bulk copy cannot take
  for (int i = int(bulk / sizeof(U)) + threadIdx.x; i < n; i += GTHREADS)
    win[i] = src[i];
  __syncthreads();
  bar_wait(&bar, 0);
  put_corners<U, K>(win, ld, id, npe, nelem, e0, out);
}

// out[n, j] = the sum over the slots of node n, in row order, from +0.0,
// of cols[j, slot], for j < K; one thread per node.
template <typename T, int K>
__global__ void __launch_bounds__(ASM_THREADS)
    asm_pack_kernel(const T* __restrict__ cols,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ slots, int nnode, int nslots,
                    T* __restrict__ out) {
  const int n = blockIdx.x * ASM_THREADS + threadIdx.x;
  if (n >= nnode) return;
  const int b = row_ptr[n], e = row_ptr[n + 1];
  int sid[UNROLL];
#pragma unroll
  for (int d = 0; d < UNROLL; ++d) sid[d] = b + d < e ? slots[b + d] : 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const T* col = cols + j * nslots;
    T v[UNROLL];
#pragma unroll
    for (int d = 0; d < UNROLL; ++d) v[d] = b + d < e ? col[sid[d]] : T(0);
    T acc = T(0);
#pragma unroll
    for (int d = 0; d < UNROLL; ++d)
      if (b + d < e) acc = acc + v[d];
    for (int p = b + UNROLL; p < e; ++p) acc = acc + col[slots[p]];
    out[n * K + j] = acc;
  }
}

struct Tiles {
  const int* conn_cm;
  const short* rel_cm;
  const int* lo;
  const int* w;
  const unsigned char* staged;
  int win_rows;  // the widest staged window
};

// The instance for the runtime k (1..KMAX); dynamic shared memory for the
// widest staged window of whole rows of ld, above 48 KB by opting in.
template <typename U, int K = 1>
int gather(const void* pack, int ld, int k, const Tiles& tb, int npe,
           int nelem, void* out, cudaStream_t st) {
  if constexpr (K < KMAX) {
    if (k != K)
      return gather<U, K + 1>(pack, ld, k, tb, npe, nelem, out, st);
  }
  const size_t smem = ((size_t)tb.win_rows * ld * sizeof(U) + 15) & ~15ul;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_corners_kernel<U, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return int(e);
  }
  gather_corners_kernel<U, K><<<(nelem + TILE - 1) / TILE, GTHREADS, smem,
                                st>>>(
      static_cast<const U*>(pack), ld, tb.conn_cm, tb.rel_cm, tb.lo, tb.w,
      tb.staged, npe, nelem, static_cast<U*>(out));
  return int(cudaGetLastError());
}

// The instance for the runtime k (1..KMAX).
template <typename T, int K = 1>
int scatter(int k, const void* cols, const int* row_ptr, const int* slots,
            int nnode, int nslots, void* out, cudaStream_t st) {
  if constexpr (K < KMAX) {
    if (k != K)
      return scatter<T, K + 1>(k, cols, row_ptr, slots, nnode, nslots, out,
                               st);
  }
  asm_pack_kernel<T, K>
      <<<(nnode + ASM_THREADS - 1) / ASM_THREADS, ASM_THREADS, 0, st>>>(
          static_cast<const T*>(cols), row_ptr, slots, nnode, nslots,
          static_cast<T*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the first launch that failed (faults
// during the run surface at the caller's next synchronisation).  is_f64
// selects the double instantiation; npe is 3 (triangles) or 4 (tets;
// the gather takes at most 4).

int des_gather_corners(int is_f64, const void* pack, int ld, int k,
                       const int* conn_cm, const short* rel_cm,
                       const int* tile_lo, const int* tile_w,
                       const unsigned char* tile_staged, int win_rows,
                       int npe, int nelem, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > KMAX || ld < k || ld > KMAX || npe < 1 || npe > 4 ||
      nelem < 1 || (long long)npe * nelem * KMAX >= (1ll << 31) ||
      win_rows < 0 || win_rows > WMAX)
    return int(cudaErrorInvalidValue);
  const Tiles tb{conn_cm, rel_cm, tile_lo, tile_w, tile_staged, win_rows};
  return is_f64 ? gather<unsigned long long>(pack, ld, k, tb, npe, nelem,
                                             out, st)
                : gather<unsigned>(pack, ld, k, tb, npe, nelem, out, st);
}

int des_scatter_corners(int is_f64, const void* cols, int k,
                        const int* row_ptr, const int* slots, int nnode,
                        int npe, int nelem, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nslots = npe * nelem;
  if (k < 1 || k > KMAX || nnode < 1 || nslots < 1)
    return int(cudaErrorInvalidValue);
  return is_f64
             ? scatter<double>(k, cols, row_ptr, slots, nnode, nslots, out, st)
             : scatter<float>(k, cols, row_ptr, slots, nnode, nslots, out, st);
}

int des_scatter_gather_corners(int is_f64, const void* cols, int k, int kg,
                               const int* row_ptr, const int* slots,
                               const int* conn_cm, const short* rel_cm,
                               const int* tile_lo, const int* tile_w,
                               const unsigned char* tile_staged,
                               int win_rows, int nnode, int npe, int nelem,
                               void* sums, void* gath, void* stream) {
  if (kg < 1 || kg > k) return int(cudaErrorInvalidValue);
  int rc = des_scatter_corners(is_f64, cols, k, row_ptr, slots, nnode, npe,
                               nelem, sums, stream);
  if (rc != 0) return rc;
  return des_gather_corners(is_f64, sums, k, kg, conn_cm, rel_cm, tile_lo,
                            tile_w, tile_staged, win_rows, npe, nelem, gath,
                            stream);
}

}  // extern "C"
