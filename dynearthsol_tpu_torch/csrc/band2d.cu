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
// The gather (gather_corners_kernel): one thread per corner slot, coalesced
// table reads and column writes; the k values of one node row are
// neighbours in memory.
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
// node of each slot; row_ptr/slots the node -> slot support as CSR in the
// order of ops/assembly.node_sum.  -fmad=false changes nothing here (there
// is no multiply) but the file is built with the others.
//
// des_scatter_gather_corners needs every nodal sum complete before any
// corner reads it, a grid-wide dependency: it is two launches on one
// stream behind one entry point (the assembly, then a gather of the first
// kg columns of the sums).  One cooperative launch with a grid sync
// between the two, and one launch in which each node's thread writes its
// sums to its own corner slots, were each slower (same place).

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;        // threads of a gather block
constexpr int KMAX = 8;
constexpr int ASM_THREADS = 128;  // nodes (threads) of an assembly block
constexpr int UNROLL = 12;        // slots of a row loaded at once

// out[j, s] = pack[conn_cm[s], j] for j < k; pack rows are ld apart.
template <typename T>
__global__ void gather_corners_kernel(const T* __restrict__ pack, int ld,
                                      int k, const int* __restrict__ conn_cm,
                                      long long nslots, T* __restrict__ out) {
  const long long s = blockIdx.x * (long long)BLOCK + threadIdx.x;
  if (s >= nslots) return;
  const T* row = pack + (long long)conn_cm[s] * ld;
  for (int j = 0; j < k; ++j) out[j * nslots + s] = row[j];
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

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + BLOCK - 1) / BLOCK);
}

template <typename T>
int gather(const void* pack, int ld, int k, const int* conn_cm,
           long long nslots, void* out, cudaStream_t st) {
  if (k < 1 || k > KMAX || ld < k || nslots < 1) return int(cudaErrorInvalidValue);
  gather_corners_kernel<T><<<blocks_for(nslots), BLOCK, 0, st>>>(
      static_cast<const T*>(pack), ld, k, conn_cm, nslots,
      static_cast<T*>(out));
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
// selects the double instantiation; npe is 3 (triangles) or 4 (tets).

int des_gather_corners(int is_f64, const void* pack, int ld, int k,
                       const int* conn_cm, int npe, int nelem, void* out,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nslots = (long long)npe * nelem;
  return is_f64 ? gather<double>(pack, ld, k, conn_cm, nslots, out, st)
                : gather<float>(pack, ld, k, conn_cm, nslots, out, st);
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
                               const int* conn_cm, int nnode, int npe,
                               int nelem, void* sums, void* gath,
                               void* stream) {
  if (kg < 1 || kg > k) return int(cudaErrorInvalidValue);
  int rc = des_scatter_corners(is_f64, cols, k, row_ptr, slots, nnode, npe,
                               nelem, sums, stream);
  if (rc != 0) return rc;
  return des_gather_corners(is_f64, sums, k, kg, conn_cm, npe, nelem, gath,
                            stream);
}

}  // extern "C"
