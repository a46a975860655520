// The best-species redundancy step: per (read, query-position group) the
// minimum-hamming candidates of the read's best species, each group
// reduced to the LCA of its extreme euler-first members, compacted into
// (read, LCA) pairs in group order, in one launch.
//
// What it replaces.  No TPU kernel: the JAX package's step is plain jnp
// (metabuli_work_tpu/models/flagship.py::redundancy_counts), and so was
// the port's torch body (models/flagship.py::redundancy_counts_ref),
// which stays as the plain version.  That body launched about 135
// device operations a call (the per-slot keys and their minima over cap,
// two scatter-mins, the euler gathers, about 50 for the binary-lifting
// loops, about 10 for the compaction) at about 26 us of host each, so
// its enqueue was 3-4.5 ms of the host's time a batch in every resident
// flow.  This kernel computes what that body computes, bit for bit
// (integer work only), on the stats column and on the first
// min(count, width) pairs; the columns past the count are left as they
// were (no consumer reads them).
//
// What bounds it on an H100.  Bytes: the bool `sel` of every [cap, N]
// candidate slot of a read that has a best species (1 byte each), the
// species, hamming and euler-first fields (12 bytes) only where `sel`
// holds, 4 bytes of query position a slot, and 8 bytes a group of the
// scratch minima.  A paired batch at cap 20 (about 440,000 slots) reads
// at most 13 B x 8.8 M = 115 MB, 34 us at 3.35 TB/s, and much less
// where `sel` is sparse; a long batch of 32 reads at most 423 MB.
//
// Design.  One cooperative launch (every block resident, so the grid
// can wait on itself) in four phases, three grid-wide barriers apart:
// 0. the group minima scratch filled with the empty key, the match
//    counter zeroed (no zeroing launch before the kernel);
// 1. a thread a query slot (grid-stride, consecutive slots on
//    consecutive lanes, so each [cap, N] row is read coalesced): the
//    slot's read and wanted species (the part_w broadcast when it
//    covers N, else q_sids), the two packed keys' minima over cap, then
//    one atomicMin each into the slot's group; matches counted in a
//    register, one warp-aggregated atomicAdd a warp;
// 2. each block counts the valid groups of its contiguous chunk of
//    groups;
// 3. each block sums the counts of the blocks before it (its first
//    output column), then walks its chunk a tile at a time with a block
//    scan, and for each valid group inside the output width takes the
//    pairwise LCA by binary lifting (the tables are a few KB and stay in
//    L1) and writes (read, LCA).  Tiles past the width are skipped.
// Groups live in global scratch, not shared memory: a long batch has
// up to B x 7,300 of them, and group ids cross blocks.

#include <stdint.h>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#endif

#ifndef REDUNDANCY_HD
#define REDUNDANCY_HD __host__ __device__ __forceinline__
#endif

namespace redundancy {

constexpr int kThreads = 256;
constexpr int kMaxParts = 4;
constexpr int kBig = 0x7FFFFFFF;         // the empty key
constexpr int kEfm = (1 << 25) - 1;      // euler-first bits of a key

struct Params {
  const unsigned char* sel;     // [cap, n]
  const int* species;           // [cap, n]
  const int* ham;               // [cap, n]
  const int* ef;                // [cap, n] euler-first index
  long long n;
  int cap;
  const int* q_pos;             // [n]
  const int* q_sids;            // [n] 1-based read ids
  const int* best;              // [b + 1] best species a read (0: none)
  long long b;
  int n_parts;                  // > 0: read ids by broadcast of part_w
  long long part_w[kMaxParts];
  long long dna_shift, n_quot, n_groups;
  const int* euler;             // [n_euler]
  long long n_euler;
  const int* depth;             // [n_nodes]
  const int* lift;              // [levels, n_nodes]
  int levels;
  long long n_nodes;
  int* g1;                      // [n_groups] min (ham, ef) keys
  int* g2;                      // [n_groups] min (ham, EFM - ef) keys
  int* block_cnt;               // [gridDim.x]
  int* out;                     // [2, 1 + width]
  long long width;
};

// The 0-based read of slot n (-1 or beyond b: no read) and its wanted
// species (0: none).  The broadcast layout holds each part's reads one
// after another, part_w[p] slots a read.
REDUNDANCY_HD void slot_read(const Params& p, long long n, long long* r0,
                             int* want) {
  if (p.n_parts > 0) {
    long long off = 0;
    for (int i = 0; i < p.n_parts; ++i) {
      const long long seg = p.b * p.part_w[i];
      if (n < off + seg) {
        *r0 = (n - off) / p.part_w[i];
        *want = p.best[*r0 + 1];
        return;
      }
      off += seg;
    }
    *r0 = -1;
    *want = 0;
    return;
  }
  const int s = p.q_sids[n];
  *r0 = (long long)s - 1;
  *want = s >= 0 && s <= p.b ? p.best[s] : 0;
}

// The group of a slot of read r0 at query position pos: r0 * n_quot +
// clamp(floor(pos / dna_shift), 0, n_quot - 1).
REDUNDANCY_HD long long group_of(const Params& p, long long r0, int pos) {
  long long q = pos / p.dna_shift;
  if (q * p.dna_shift != pos && pos < 0) --q;
  q = q < 0 ? 0 : q;
  q = q > p.n_quot - 1 ? p.n_quot - 1 : q;
  return r0 * p.n_quot + q;
}

// The packed keys: hamming above a 25-bit euler-first index, so that one
// minimum gives a group's least hamming and its least (key1) or greatest
// (key2) euler-first index among the rows at that hamming.
REDUNDANCY_HD int key1(int ham, int ef) {
  return (int)(((unsigned)ham << 25) | (unsigned)ef);
}

REDUNDANCY_HD int key2(int ham, int ef) {
  return (int)(((unsigned)ham << 25) | ((unsigned)kEfm - (unsigned)ef));
}

// The LCA of the taxa at euler-first indices fmin and fmax (clamped to
// the tour), by binary lifting over depth and lift.
REDUNDANCY_HD int pair_lca(const Params& p, int fmin, int fmax) {
  const long long last = p.n_euler - 1;
  const int a = p.euler[fmin < last ? fmin : last];
  const int b = p.euler[fmax < last ? fmax : last];
  const int da = p.depth[a], db = p.depth[b];
  int x = db > da ? b : a, y = db > da ? a : b;
  const long long diff = da > db ? (long long)da - db : (long long)db - da;
  for (int k = 0; k < p.levels; ++k)
    if ((diff >> k) & 1) x = p.lift[k * p.n_nodes + x];
  const bool eq = x == y;
  for (int k = p.levels - 1; k >= 0; --k) {
    const int lx = p.lift[k * p.n_nodes + x], ly = p.lift[k * p.n_nodes + y];
    if (lx != ly) {
      x = lx;
      y = ly;
    }
  }
  return eq ? x : p.lift[x];
}

#ifdef __CUDACC__

// The sum of v over the block, in every thread.
__device__ __forceinline__ int block_sum(int v, int* warp_sum) {
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();                        // warp_sum free again
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
    redundancy_kernel(const __grid_constant__ Params p) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ int warp_sum[kThreads / 32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  int* matches = p.out + 1 + p.width;     // row 1, column 0

  // 0. empty group minima, zero matches
  for (long long g = tid; g < p.n_groups; g += stride) {
    p.g1[g] = kBig;
    p.g2[g] = kBig;
  }
  if (tid == 0) *matches = 0;
  grid.sync();

  // 1. per slot: the keys' minima over cap, into the slot's group
  unsigned cnt = 0;
  for (long long n = tid; n < p.n; n += stride) {
    long long r0;
    int want;
    slot_read(p, n, &r0, &want);
    if (want <= 0) continue;
    int s1 = kBig, s2 = kBig;
    for (int c = 0; c < p.cap; ++c) {
      const long long i = (long long)c * p.n + n;
      if (!p.sel[i] || p.species[i] != want) continue;
      const int h = p.ham[i], e = p.ef[i];
      s1 = min(s1, key1(h, e));
      s2 = min(s2, key2(h, e));
      ++cnt;
    }
    if (s1 == kBig && s2 == kBig) continue;
    const long long g = group_of(p, r0, p.q_pos[n]);
    if (g < 0 || g >= p.n_groups) continue;   // dropped, as the scatter's
    if (s1 < kBig) atomicMin(p.g1 + g, s1);
    if (s2 < kBig) atomicMin(p.g2 + g, s2);
  }
  cnt = __reduce_add_sync(full, cnt);
  if (lane == 0 && cnt) atomicAdd(reinterpret_cast<unsigned*>(matches), cnt);
  grid.sync();

  // 2. valid groups of this block's chunk
  const long long chunk = (p.n_groups + gridDim.x - 1) / gridDim.x;
  const long long lo = min(p.n_groups, (long long)blockIdx.x * chunk);
  const long long hi = min(p.n_groups, lo + chunk);
  int mine = 0;
  for (long long g = lo + threadIdx.x; g < hi; g += kThreads)
    mine += p.g1[g] < kBig;
  mine = block_sum(mine, warp_sum);
  if (threadIdx.x == 0) p.block_cnt[blockIdx.x] = mine;
  grid.sync();

  // 3. this block's first output column, then its pairs in group order
  int before = 0, total = 0;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads) {
    const int c = p.block_cnt[k];
    total += c;
    before += k < (int)blockIdx.x ? c : 0;
  }
  before = block_sum(before, warp_sum);
  total = block_sum(total, warp_sum);
  if (tid == 0) p.out[0] = total;
  long long at = before;
  for (long long base = lo; base < hi && at < p.width; base += kThreads) {
    const long long g = base + threadIdx.x;
    const int k1 = g < hi ? p.g1[g] : kBig;
    const bool valid = k1 < kBig;
    const unsigned ballot = __ballot_sync(full, valid);
    __syncthreads();                      // warp_sum free again
    if (lane == 0) warp_sum[warp] = __popc(ballot);
    __syncthreads();
    int ahead = 0, tile = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      ahead += w < warp ? warp_sum[w] : 0;
      tile += warp_sum[w];
    }
    const long long pos = at + ahead + __popc(ballot & ((1u << lane) - 1));
    if (valid && pos < p.width) {
      const int k2 = p.g2[g];
      p.out[1 + pos] = (int)(g / p.n_quot + 1);
      p.out[2 + p.width + pos] = pair_lca(p, k1 & kEfm, kEfm - (k2 & kEfm));
    }
    at += tile;
  }
}

#endif  // __CUDACC__

}  // namespace redundancy

#ifdef __CUDACC__

extern "C" {

// Launches the step on `stream`: sel/species/ham/ef [cap, n], q_pos and
// q_sids [n], best [b + 1], part_w (n_parts entries, at most kMaxParts;
// read ids by broadcast when they cover n: sum(part_w) * b == n),
// euler [n_euler], depth [n_nodes], lift [levels, n_nodes].  scratch
// holds 2 * b * n_quot + max_blocks int32; out is [2, 1 + width].
// Writes the pair count and the match count in column 0 and the first
// min(count, width) pairs after it.  Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for shapes or options it does not
// take.
int redundancy_launch(const unsigned char* sel, const int* species,
                      const int* ham, const int* ef, long long n, int cap,
                      const int* q_pos, const int* q_sids, const int* best,
                      long long b, const long long* part_w, int n_parts,
                      long long dna_shift, long long n_quot,
                      const int* euler, long long n_euler, const int* depth,
                      const int* lift, int levels, long long n_nodes,
                      int* scratch, long long max_blocks, int* out,
                      long long width, void* stream) {
  using redundancy::kThreads;
  if (n < 0 || cap < 0 || b < 0 || n_parts < 0 ||
      n_parts > redundancy::kMaxParts || dna_shift < 1 || n_quot < 1 ||
      n_euler < 1 || n_nodes < 1 || levels < 1 || levels > 62 ||
      max_blocks < 1 || width < 0)
    return (int)cudaErrorInvalidValue;
  redundancy::Params p{};
  p.sel = sel;
  p.species = species;
  p.ham = ham;
  p.ef = ef;
  p.n = n;
  p.cap = cap;
  p.q_pos = q_pos;
  p.q_sids = q_sids;
  p.best = best;
  p.b = b;
  long long covered = 0;
  for (int i = 0; i < n_parts; ++i) {
    if (part_w[i] < 1) return (int)cudaErrorInvalidValue;
    p.part_w[i] = part_w[i];
    covered += part_w[i];
  }
  p.n_parts = n_parts > 0 && covered * b == n ? n_parts : 0;
  p.dna_shift = dna_shift;
  p.n_quot = n_quot;
  p.n_groups = b * n_quot;
  p.euler = euler;
  p.n_euler = n_euler;
  p.depth = depth;
  p.lift = lift;
  p.levels = levels;
  p.n_nodes = n_nodes;
  p.g1 = scratch;
  p.g2 = scratch + p.n_groups;
  p.block_cnt = scratch + 2 * p.n_groups;
  p.out = out;
  p.width = width;

  // the grid: enough blocks for the slots and the groups, no more than
  // the card holds at once (a cooperative launch's condition)
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0, coop = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, redundancy::redundancy_kernel, kThreads, 0)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess)
      return (int)err;
    if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const long long work = n > p.n_groups ? n : p.n_groups;
  long long blocks = (work + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : blocks;
  blocks = blocks < resident[dev] ? blocks : resident[dev];
  blocks = blocks < max_blocks ? blocks : max_blocks;
  void* args[] = {&p};
  cudaLaunchCooperativeKernel((const void*)redundancy::redundancy_kernel,
                              dim3((unsigned)blocks), dim3(kThreads), args,
                              0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
