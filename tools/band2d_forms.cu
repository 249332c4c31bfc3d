// Other forms of the kernels of dynearthsol_tpu_torch/csrc/band2d.cu,
// float32, kept to be measured beside the shipped ones by
// tools/band2d_forms.py.  Same layouts; the assembly forms keep the same
// fixed-order sums (each node's slots in row order, from +0.0), the gather
// forms copy 4-byte words.
//
// The nodal assembly (band2d_form):
//   field   -- one thread per (node, field), the row walked one slot after
//              the other (a chain slots[p] -> cols[..]): the assembly
//              kernel band2d.cu had before the per-node one
//   staged  -- blocks of BN nodes: the block's CSR span of slot ids read
//              coalesced, every (slot, field) value loaded into a
//              shared-memory tile with independent loads, then each
//              (node, field) adds its row of the tile
//   coop    -- asm_gather as one cooperative launch: persistent blocks run
//              `staged` over the node blocks, one grid sync, then walk the
//              corner slots gathering the first kg sums
//   owner   -- asm_gather as one launch: one thread per node sums its row
//              (as band2d.cu's asm_pack_kernel) and writes its first kg
//              sums to its own corner slots
//
// The corner gather (band2d_gather_form), K of every ld columns:
//   slot    -- one thread per corner slot reading the pack directly: the
//              gather kernel band2d.cu had before the tiled one
//   tiles   -- one block per tile of TL elements, its window staged by one
//              bulk copy, the slot ids loaded meanwhile (band2d.cu's
//              gather_corners_kernel at another tile size)
//   rel32   -- `tiles` reading the int32 conn_cm and subtracting the
//              window base in place of the int16 relative ids
//   persist -- a persistent grid walking the tiles, the next tile's window
//              copied into a second buffer while the current one is read
//   nt128, nt512 -- `tiles` at 1024 elements with 128 or 512 threads a
//              block (4 and 2 elements a thread at 256)
//   stcs    -- `tiles` at 1024 elements writing with streaming stores
//
// Includes csrc/band2d.cu for its bulk-copy helpers and constants.
#include <cooperative_groups.h>

#include "../dynearthsol_tpu_torch/csrc/band2d.cu"

namespace cg = cooperative_groups;

namespace {

constexpr int T = 256;   // threads of a block
constexpr int BN = 64;   // nodes of a staged block

template <int K>
__global__ void field(const float* __restrict__ cols,
                      const int* __restrict__ rp,
                      const int* __restrict__ slots, int nn, int ns,
                      float* __restrict__ out) {
  const int i = blockIdx.x * T + threadIdx.x;
  if (i >= nn * K) return;
  const int n = i / K, j = i - n * K;
  float acc = 0.f;
  for (int p = rp[n]; p < rp[n + 1]; ++p) acc = acc + cols[j * ns + slots[p]];
  out[i] = acc;
}

template <int K>
__device__ void staged_block(const float* __restrict__ cols,
                             const int* __restrict__ rp,
                             const int* __restrict__ slots, int nn, int ns,
                             int vb, float* tile, int* off,
                             float* __restrict__ out) {
  constexpr int KS = K | 1;  // odd row stride: no bank conflicts
  const int n0 = vb * BN, nb = min(BN, nn - n0);
  const int span0 = rp[n0], len = rp[n0 + nb] - span0;
  for (int i = threadIdx.x; i <= nb; i += T) off[i] = rp[n0 + i] - span0;
  for (int t = threadIdx.x; t < len; t += T) {
    const int s = slots[span0 + t];
    float v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = cols[j * ns + s];
#pragma unroll
    for (int j = 0; j < K; ++j) tile[t * KS + j] = v[j];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nb * K; q += T) {
    const int i = q / K, j = q - i * K;
    float acc = 0.f;
    for (int p = off[i]; p < off[i + 1]; ++p) acc = acc + tile[p * KS + j];
    out[n0 * K + q] = acc;
  }
}

// maxdeg: the tables' largest row, so that BN rows fit the tile
template <int K>
__global__ void staged(const float* __restrict__ cols,
                       const int* __restrict__ rp,
                       const int* __restrict__ slots, int nn, int ns,
                       int maxdeg, float* __restrict__ out) {
  extern __shared__ float sm[];
  staged_block<K>(cols, rp, slots, nn, ns, blockIdx.x, sm,
                  reinterpret_cast<int*>(sm + BN * maxdeg * (K | 1)), out);
}

template <int K>
__global__ void coop(const float* __restrict__ cols,
                     const int* __restrict__ rp,
                     const int* __restrict__ slots,
                     const int* __restrict__ conn, int nn, int ns,
                     int maxdeg, int kg, float* __restrict__ sums,
                     float* __restrict__ gath) {
  extern __shared__ float sm[];
  int* off = reinterpret_cast<int*>(sm + BN * maxdeg * (K | 1));
  for (int vb = blockIdx.x; vb < (nn + BN - 1) / BN; vb += gridDim.x) {
    staged_block<K>(cols, rp, slots, nn, ns, vb, sm, off, sums);
    __syncthreads();
  }
  cg::this_grid().sync();
  for (int s = blockIdx.x * T + threadIdx.x; s < ns; s += gridDim.x * T)
    for (int j = 0; j < kg; ++j)
      gath[j * ns + s] = __ldcg(sums + conn[s] * K + j);
}

template <int K>
__global__ void owner(const float* __restrict__ cols,
                      const int* __restrict__ rp,
                      const int* __restrict__ slots, int nn, int ns, int kg,
                      float* __restrict__ sums, float* __restrict__ gath) {
  const int n = blockIdx.x * T + threadIdx.x;
  if (n >= nn) return;
  const int b = rp[n], e = rp[n + 1];
  int sid[UNROLL];
#pragma unroll
  for (int d = 0; d < UNROLL; ++d) sid[d] = b + d < e ? slots[b + d] : 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float* col = cols + j * ns;
    float v[UNROLL];
#pragma unroll
    for (int d = 0; d < UNROLL; ++d) v[d] = b + d < e ? col[sid[d]] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < UNROLL; ++d)
      if (b + d < e) acc = acc + v[d];
    for (int p = b + UNROLL; p < e; ++p) acc = acc + col[slots[p]];
    sums[n * K + j] = acc;
    if (j >= kg) continue;
#pragma unroll
    for (int d = 0; d < UNROLL; ++d)
      if (b + d < e) gath[j * ns + sid[d]] = acc;
    for (int p = b + UNROLL; p < e; ++p) gath[j * ns + slots[p]] = acc;
  }
}

template <int K>
int run(int form, const float* cols, const int* rp, const int* slots,
        const int* conn, int nn, int ns, int maxdeg, int kg, float* sums,
        float* gath, cudaStream_t st) {
  const size_t smem = size_t(BN) * maxdeg * (K | 1) * 4 + (BN + 1) * 4;
  const int nvb = (nn + BN - 1) / BN;
  if (smem > 48 * 1024) return int(cudaErrorInvalidValue);
  if (form == 0) field<K><<<(nn * K + T - 1) / T, T, 0, st>>>(
      cols, rp, slots, nn, ns, sums);
  if (form == 1) staged<K><<<nvb, T, smem, st>>>(cols, rp, slots, nn, ns,
                                                 maxdeg, sums);
  if (form == 2) {
    int dev, sms, bps;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, coop<K>, T, smem);
    const int grid = nvb < bps * sms ? nvb : bps * sms;
    void* args[] = {&cols, &rp, &slots, &conn, &nn, &ns,
                    &maxdeg, &kg, &sums, &gath};
    cudaError_t e = cudaLaunchCooperativeKernel((const void*)coop<K>,
                                                dim3(grid), dim3(T), args,
                                                smem, st);
    if (e != cudaSuccess) return int(e);
  }
  if (form == 3) owner<K><<<(nn + T - 1) / T, T, 0, st>>>(
      cols, rp, slots, nn, ns, kg, sums, gath);
  return int(cudaGetLastError());
}

// ---- the gather forms

template <int K>
__global__ void slot_gather(const unsigned* __restrict__ pack, int ld,
                            const int* __restrict__ conn, int ns,
                            unsigned* __restrict__ out) {
  const int s = blockIdx.x * T + threadIdx.x;
  if (s >= ns) return;
  const unsigned* row = pack + (long long)conn[s] * ld;
#pragma unroll
  for (int j = 0; j < K; ++j) out[j * ns + s] = row[j];
}

// Each thread's slot ids for the tile at e0 (TL / GTHREADS elements a
// thread): relative to the window if staged (int16, or REL32: the int32
// node id less lo), else the node ids.
template <int E, bool REL32, int NT = GTHREADS>
__device__ void tile_ids(int (&id)[E][4], bool staged, int lo,
                         const int* __restrict__ conn,
                         const short* __restrict__ rel, int npe, int nelem,
                         int e0) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = e0 + i * NT + threadIdx.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = c * nelem + e;
      id[i][c] = e >= nelem || c >= npe ? 0
                 : !staged              ? conn[s]
                 : REL32                ? conn[s] - lo
                                        : (unsigned short)rel[s];
    }
  }
}

// Start a window into buf: one thread's bulk copy, every thread a share of
// the last < 16 bytes.
__device__ void stage(const unsigned* __restrict__ pack, int ld, int lo,
                      int w, unsigned* buf, unsigned long long* bar) {
  const unsigned* src = pack + (long long)lo * ld;
  const int n = w * ld;
  const unsigned bulk = (n * 4u) & ~15u;
  if (threadIdx.x == 0) bulk_load(buf, src, bulk, bar);
  for (int i = int(bulk / 4) + threadIdx.x; i < n; i += blockDim.x)
    buf[i] = src[i];
}

// put_corners for NT threads a block, with streaming stores if STCS
template <int K, int E, int NT, bool STCS>
__device__ void put_nt(const unsigned* from, int ld, const int (&id)[E][4],
                       int npe, int nelem, int e0,
                       unsigned* __restrict__ out) {
  const int ns = npe * nelem;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = e0 + i * NT + threadIdx.x;
    if (e >= nelem) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= npe) break;
      const unsigned* row = from + id[i][c] * ld;
      unsigned v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = row[j];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (STCS)
          __stcs(out + j * ns + c * nelem + e, v[j]);
        else
          out[j * ns + c * nelem + e] = v[j];
      }
    }
  }
}

// `tiles` at 1024 elements with NT threads a block, STCS streaming stores
template <int K, int NT, bool STCS>
__global__ void __launch_bounds__(NT)
    tile_gather_nt(const unsigned* __restrict__ pack, int ld,
                   const int* __restrict__ conn,
                   const short* __restrict__ rel, const int* __restrict__ lo,
                   const int* __restrict__ w,
                   const unsigned char* __restrict__ staged, int npe,
                   int nelem, unsigned* __restrict__ out) {
  constexpr int E = 1024 / NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  unsigned* win = reinterpret_cast<unsigned*>(smem);
  const int t = blockIdx.x, e0 = t * 1024;
  const bool st = staged[t];
  if (st) {
    if (threadIdx.x == 0) bar_init(&bar);
    stage(pack, ld, lo[t], w[t], win, &bar);
  }
  int id[E][4];
  tile_ids<E, false, NT>(id, st, lo[t], conn, rel, npe, nelem, e0);
  if (!st) {
    put_nt<K, E, NT, STCS>(pack, ld, id, npe, nelem, e0, out);
    return;
  }
  __syncthreads();
  bar_wait(&bar, 0);
  put_nt<K, E, NT, STCS>(win, ld, id, npe, nelem, e0, out);
}

template <int K, int TL, bool REL32>
__global__ void __launch_bounds__(GTHREADS)
    tile_gather(const unsigned* __restrict__ pack, int ld,
                const int* __restrict__ conn, const short* __restrict__ rel,
                const int* __restrict__ lo, const int* __restrict__ w,
                const unsigned char* __restrict__ staged, int npe,
                int nelem, unsigned* __restrict__ out) {
  constexpr int E = TL / GTHREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  unsigned* win = reinterpret_cast<unsigned*>(smem);
  const int t = blockIdx.x, e0 = t * TL;
  const bool st = staged[t];
  if (st) {
    if (threadIdx.x == 0) bar_init(&bar);
    stage(pack, ld, lo[t], w[t], win, &bar);
  }
  int id[E][4];
  tile_ids<E, REL32>(id, st, lo[t], conn, rel, npe, nelem, e0);
  if (!st) {
    put_corners<unsigned, K, E>(pack, ld, id, npe, nelem, e0, out);
    return;
  }
  __syncthreads();
  bar_wait(&bar, 0);
  put_corners<unsigned, K, E>(win, ld, id, npe, nelem, e0, out);
}

// buf_words: one buffer's words, a multiple of 4 (16 bytes)
template <int K, int TL>
__global__ void __launch_bounds__(GTHREADS)
    persist_gather(const unsigned* __restrict__ pack, int ld,
                   const int* __restrict__ conn,
                   const short* __restrict__ rel, const int* __restrict__ lo,
                   const int* __restrict__ w,
                   const unsigned char* __restrict__ staged, int ntiles,
                   int buf_words, int npe, int nelem,
                   unsigned* __restrict__ out) {
  constexpr int E = TL / GTHREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar[2];
  unsigned* buf[2] = {reinterpret_cast<unsigned*>(smem),
                      reinterpret_cast<unsigned*>(smem) + buf_words};
  unsigned parity[2] = {0, 0};
  int t = blockIdx.x;
  if (threadIdx.x == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
  }
  if (staged[t]) stage(pack, ld, lo[t], w[t], buf[0], &bar[0]);
  __syncthreads();
  for (int i = 0; t < ntiles; ++i, t += gridDim.x) {
    const int b = i & 1, tn = t + gridDim.x;
    // buf[b ^ 1] was last read before the previous __syncthreads
    if (tn < ntiles && staged[tn])
      stage(pack, ld, lo[tn], w[tn], buf[b ^ 1], &bar[b ^ 1]);
    int id[E][4];
    tile_ids<E, false>(id, staged[t], lo[t], conn, rel, npe, nelem, t * TL);
    if (staged[t]) {
      bar_wait(&bar[b], parity[b]);
      parity[b] ^= 1;
      put_corners<unsigned, K, E>(buf[b], ld, id, npe, nelem, t * TL, out);
    } else {
      put_corners<unsigned, K, E>(pack, ld, id, npe, nelem, t * TL, out);
    }
    __syncthreads();
  }
}

template <typename F>
int opt_in(F kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <int K, int TL>
int gather_form(int form, int ld, const unsigned* pack, const int* conn,
                const short* rel, const int* lo, const int* w,
                const unsigned char* staged, int ntiles, int win_rows,
                int npe, int nelem, unsigned* out, cudaStream_t st) {
  const int ns = npe * nelem;
  const int buf_words = (win_rows * ld + 3) & ~3;
  const size_t smem = size_t(buf_words) * 4;
  int rc = 0;
  if (form == 0)
    slot_gather<K><<<(ns + T - 1) / T, T, 0, st>>>(pack, ld, conn, ns, out);
  if (form == 1 && !(rc = opt_in(tile_gather<K, TL, false>, smem)))
    tile_gather<K, TL, false><<<ntiles, GTHREADS, smem, st>>>(
        pack, ld, conn, rel, lo, w, staged, npe, nelem, out);
  if (form == 2 && !(rc = opt_in(tile_gather<K, TL, true>, smem)))
    tile_gather<K, TL, true><<<ntiles, GTHREADS, smem, st>>>(
        pack, ld, conn, rel, lo, w, staged, npe, nelem, out);
  if (form == 3 && !(rc = opt_in(persist_gather<K, TL>, 2 * smem))) {
    int dev, sms, bps;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &bps, persist_gather<K, TL>, GTHREADS, 2 * smem);
    const int grid = ntiles < bps * sms ? ntiles : bps * sms;
    persist_gather<K, TL><<<grid, GTHREADS, 2 * smem, st>>>(
        pack, ld, conn, rel, lo, w, staged, ntiles, buf_words, npe, nelem,
        out);
  }
  if (TL == 1024 && form == 4 &&
      !(rc = opt_in(tile_gather_nt<K, 128, false>, smem)))
    tile_gather_nt<K, 128, false><<<ntiles, 128, smem, st>>>(
        pack, ld, conn, rel, lo, w, staged, npe, nelem, out);
  if (TL == 1024 && form == 5 &&
      !(rc = opt_in(tile_gather_nt<K, 512, false>, smem)))
    tile_gather_nt<K, 512, false><<<ntiles, 512, smem, st>>>(
        pack, ld, conn, rel, lo, w, staged, npe, nelem, out);
  if (TL == 1024 && form == 6 &&
      !(rc = opt_in(tile_gather_nt<K, 256, true>, smem)))
    tile_gather_nt<K, 256, true><<<ntiles, 256, smem, st>>>(
        pack, ld, conn, rel, lo, w, staged, npe, nelem, out);
  return rc ? rc : int(cudaGetLastError());
}

template <int K>
int gather_tile(int form, int tile, int ld, const unsigned* pack,
                const int* conn, const short* rel, const int* lo,
                const int* w, const unsigned char* staged, int ntiles,
                int win_rows, int npe, int nelem, unsigned* out,
                cudaStream_t st) {
  if (tile == 256)
    return gather_form<K, 256>(form, ld, pack, conn, rel, lo, w, staged,
                               ntiles, win_rows, npe, nelem, out, st);
  if (tile == 512)
    return gather_form<K, 512>(form, ld, pack, conn, rel, lo, w, staged,
                               ntiles, win_rows, npe, nelem, out, st);
  if (tile == 1024)
    return gather_form<K, 1024>(form, ld, pack, conn, rel, lo, w, staged,
                                ntiles, win_rows, npe, nelem, out, st);
  if (tile == 2048)
    return gather_form<K, 2048>(form, ld, pack, conn, rel, lo, w, staged,
                                ntiles, win_rows, npe, nelem, out, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// gather form 0 slot, 1 tiles, 2 rel32, 3 persist, at tile 256, 512,
// 1024 or 2048 (the tables' own); at 1024 also 4 tiles with 128 threads a
// block, 5 with 512, 6 with streaming stores; k 1, 2 or 6 columns of every ld
extern "C" int band2d_gather_form(int form, int tile, int k, int ld,
                                  const unsigned* pack, const int* conn,
                                  const short* rel, const int* lo,
                                  const int* w, const unsigned char* staged,
                                  int ntiles, int win_rows, int npe,
                                  int nelem, unsigned* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1)
    return gather_tile<1>(form, tile, ld, pack, conn, rel, lo, w, staged,
                          ntiles, win_rows, npe, nelem, out, st);
  if (k == 2)
    return gather_tile<2>(form, tile, ld, pack, conn, rel, lo, w, staged,
                          ntiles, win_rows, npe, nelem, out, st);
  if (k == 6)
    return gather_tile<6>(form, tile, ld, pack, conn, rel, lo, w, staged,
                          ntiles, win_rows, npe, nelem, out, st);
  return int(cudaErrorInvalidValue);
}

// form 0 field, 1 staged (sums only), 2 coop, 3 owner; k 1, 2 or 5
extern "C" int band2d_form(int form, int k, const float* cols, const int* rp,
                           const int* slots, const int* conn, int nn, int ns,
                           int maxdeg, int kg, float* sums, float* gath,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) return run<1>(form, cols, rp, slots, conn, nn, ns, maxdeg, kg,
                            sums, gath, st);
  if (k == 2) return run<2>(form, cols, rp, slots, conn, nn, ns, maxdeg, kg,
                            sums, gath, st);
  if (k == 5) return run<5>(form, cols, rp, slots, conn, nn, ns, maxdeg, kg,
                            sums, gath, st);
  return int(cudaErrorInvalidValue);
}
