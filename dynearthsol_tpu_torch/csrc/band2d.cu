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
// slowly and multiplies fast.  Nothing of that is kept: here a thread reads
// the node or the slot it needs.
//
// What bounds them on this card: memory traffic, and within it the random
// reads.  No arithmetic but the sums.  A gather of k fields reads the
// (nnode, k) pack and the corner table and writes npe * k element columns;
// an assembly reads npe * k element columns and the CSR support and writes
// (nnode, k) sums.  What the design does about it: every streaming access
// (table reads, output writes) is coalesced, one thread per corner slot or
// per (node, field); the random side reads k neighbouring values of one
// node row (gather) or, per field, slots that neighbouring nodes share
// elements for (assembly), and the mesh generator's renumbering along the
// longest axis keeps those within a few cache lines of each other, so they
// are served from L1/L2 (the whole working set of the 277k-triangle mesh,
// about 30 MB, fits the 50 MB L2).
//
// Layouts (ops/band2d.py): nodal packs (nnode, k) row-major; element packs
// (k, npe, nelem), slot = corner * nelem + e; conn_cm (npe * nelem) the
// node of each slot; row_ptr/slots the node -> slot support as CSR in the
// order of ops/assembly.node_sum.
//
// The assembly adds each node's slots in row order, from +0.0, one thread
// per sum: no atomics, so the result equals node_sum's bit for bit and is
// the same on every run.  -fmad=false changes nothing here (there is no
// multiply) but the file is built with the others.
//
// des_scatter_gather_corners needs every nodal sum complete before any
// corner reads it, a grid-wide dependency: it is two launches on one
// stream behind one entry point (the assembly, then a gather of the first
// kg columns of the sums).

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int KMAX = 8;

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

// out[n, j] = sum over the slots of node n, in row order, of cols[j, slot].
template <typename T>
__global__ void scatter_corners_kernel(const T* __restrict__ cols, int k,
                                       const int* __restrict__ row_ptr,
                                       const int* __restrict__ slots,
                                       long long nnode, long long nslots,
                                       T* __restrict__ out) {
  const long long i = blockIdx.x * (long long)BLOCK + threadIdx.x;
  if (i >= nnode * k) return;
  const long long n = i / k;
  const int j = int(i - n * k);
  const T* col = cols + j * nslots;
  T acc = T(0);
  const int end = row_ptr[n + 1];
  for (int p = row_ptr[n]; p < end; ++p) acc = acc + col[slots[p]];
  out[i] = acc;
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

template <typename T>
int scatter(const void* cols, int k, const int* row_ptr, const int* slots,
            long long nnode, long long nslots, void* out, cudaStream_t st) {
  if (k < 1 || k > KMAX || nnode < 1 || nslots < 1)
    return int(cudaErrorInvalidValue);
  scatter_corners_kernel<T><<<blocks_for(nnode * k), BLOCK, 0, st>>>(
      static_cast<const T*>(cols), k, row_ptr, slots, nnode, nslots,
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
  const long long nslots = (long long)npe * nelem;
  return is_f64
             ? scatter<double>(cols, k, row_ptr, slots, nnode, nslots, out, st)
             : scatter<float>(cols, k, row_ptr, slots, nnode, nslots, out, st);
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
