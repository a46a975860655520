// Fused candidate rank + consecutive-match path DP + blocked emission,
// warp variant (used for cap <= 32; path_dp.cu takes cap > 32).
//
// Replaces the TPU kernel metabuli_work_tpu/ops/dp_pallas.py::_dp_kernel
// (launched by path_dp_blocked), as path_dp.cu does, and computes the
// same thing: for every read x frame lane g, what ops/dp_torch.py's
// sort_candidates -> path_dp -> pack_paths_blocked compute on
// lane-flipped inputs (the plain version is
// ops/dp_cuda.py::path_dp_blocked_ref), i.e. the reference's
// Taxonomer::getMatchPaths (src/commons/Taxonomer.cpp:487-648).
//
// What bounds it on an H100.  The bytes are small (each input word read
// once, block_w*5 output words per lane): at the main path's shapes the
// byte bound is ~0.01 ms.  The work per lane is one chain of W + S
// window steps, each a compare of every live candidate against the live
// predecessors of the last S windows.  On real reads a lane-window holds
// about one live candidate, so the compares are few and the kernel is
// bound by the latency of each step's chain of dependent operations and
// by how many chains run side by side.
//
// Design.
// - A lane's candidates fit one warp.  The warp is cut into groups of
//   P = next power of two >= cap threads; each group owns one lane and
//   thread j of a group owns candidate j (32 / P lanes per warp, kWarps
//   warps per block).  Nothing synchronises more than one warp: a step
//   is ordered by the warp's votes and one __syncwarp.
// - Each thread keeps its candidate's state for the last S windows in
//   registers (a shift register, newest first; S is a template
//   argument) and publishes the fields other threads read (species,
//   key, score, depth, hamming, start, first rh, position) to a per-warp
//   shared-memory ring of S + 1 window positions: a step writes the
//   position retired one step earlier, so one __syncwarp per step
//   orders every write before its readers.  A thread with a live
//   candidate reads, with one 16-byte load each, only the predecessors
//   that a ballot shows live in its group, nearest window first, and
//   stops at the first window holding its species.
// - Connection marks are warp OR-reductions (__reduce_or_sync) of each
//   thread's predecessor bitmask over warp lane ids (groups own disjoint
//   bits); "any emission" is a ballot and the emit count a popcount;
//   an emitted path's rank reads its group's emitters' keys from the
//   ring.
// - Inputs are staged out of the serial chain: each warp copies the
//   five fields of its lanes for a tile of kWT windows global->shared
//   with cp.async (4-byte LDGSTS, any W), double-buffered, so tile t+1
//   loads while tile t runs.  The copy is per warp, so __syncwarp after
//   cp.async.wait_group makes it visible; no block barrier is needed.
// - Emitted paths go straight to their slot of cols[:, slot, g], once
//   per lane and slot; empty slots are zeroed at the end and one
//   atomicAdd per overflowing lane counts blk_over.
// Bit-exactness: candidates stay unsorted; the predecessor is the first
// strict score max in (max score, min (ham<<24 | dna) key, min lane)
// order and emitted paths are ranked by (key, lane), which is the order
// the stable sort of the plain version gives.  The current and the
// predecessor DNA and hamming are read back from that key, as the plain
// version unpacks them from its sort key.  Scores are sums of multiples
// of 0.5 far below 2^24, so each add is exact; they still run one at a
// time in the reference order (built with --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#include "path_dp_common.cuh"

namespace {

using path_dp::codon_score;
using path_dp::kBigKey;

constexpr int kWarps = 4;              // warps per block
constexpr int kWT = 8;                 // windows per staged tile
constexpr int kFields = 5;             // sp, dna, rh, ham, pos
constexpr int kMaxShift = 8;           // 24-bit DNA codes: shift <= 8 codons
constexpr unsigned kFull = 0xFFFFFFFFu;
// one staged tile per warp: [kWT][kFields][32] int32.  A copy
// instruction writes kWT windows x 32 / kWT candidate slots; padding each
// window row by 32 / kWT words puts those writes in distinct banks.
constexpr int kRowWords = kFields * 32 + 32 / kWT;
constexpr int kTileWords = kWT * kRowWords;
constexpr int kTilesWords = 2 * kTileWords;     // double-buffered

// per-warp shared memory: the tiles, then the ring of S + 1 window
// positions x 32 threads x two int4 (A = sp, key, score, depth;
// B = ham, start, rhs, pos)
__host__ __device__ constexpr int warp_words(int S) {
  return kTilesWords + (S + 1) * 32 * 8;
}

struct Params {
  const int* in[kFields];  // [cap, G, W] each: sp (euk flag bit 30, -1 =
                           // none), dna, rh, ham, pos
  int* cols;               // [n_cols, block_w, G]
  unsigned char* valid;    // [block_w, G]
  int* blk_over;           // [1], zeroed by the caller
  int cap, G, W, block_w, kmer_format, dyn_gap, min_cons, min_cons_euk,
      compact5, log2p;
};

// The owning thread's candidate in each of the last S windows (slot 0 =
// the previous window).
template <int S>
struct Ring {
  int sp[S], key[S], depth[S], ham[S], start[S], rhs[S], rhe[S], pos[S];
  float score[S];
  bool conn[S];
};

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issues the copies of tile [t0, t0 + kWT) of this warp's lanes (first
// lane gw0) into `buf`.  Thread (k = lane / (32 / kWT), q = the rest)
// copies window t0 + k of candidate slots q, q + 32 / kWT, ...
__device__ __forceinline__ void stage_tile(const Params& p, int* buf,
                                           int gw0, int t0, int lane) {
  constexpr int kQ = 32 / kWT;
  const int k = lane / kQ;
  if (t0 + k >= p.W) return;
  const int pmask = (1 << p.log2p) - 1;
  for (int slot = lane % kQ; slot < 32; slot += kQ) {
    const int j = slot & pmask, g = gw0 + (slot >> p.log2p);
    if (j >= p.cap || g >= p.G) continue;
    const long long off = ((long long)j * p.G + g) * p.W + t0 + k;
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      cp_async4(buf + k * kRowWords + f * 32 + slot, p.in[f] + off);
  }
}

// Per-thread constants of a lane group.
struct Lane {
  int lane;       // thread's warp lane
  int j;          // candidate index in the group
  int gbase;      // warp lane of the group's candidate 0
  unsigned gmask; // the group's bits in a warp-wide mask
  int g;          // read x frame lane
  bool fwd;       // forward frame (consecutiveness formula)
};

// One window step: predecessor choice for the current candidate, then
// the oldest ring slot retires (emission), then the current window's
// state enters the ring.  `head` is the ring position of slot 0.
template <int S>
__device__ __forceinline__ void step(const Params& p, const Lane& L,
                                     Ring<S>& r, int4* ringA, int4* ringB,
                                     int& head, int& cnt, int sp_w,
                                     int dna_w, int rh_w, int ham_w,
                                     int pos_w) {
  constexpr int kPos = S + 1;
  const bool sel = sp_w >= 0;
  const int key_w =
      sel ? (int)(((unsigned)ham_w << 24) | (unsigned)dna_w) : kBigKey;
  const unsigned nd = (unsigned)key_w & 0xFFFFFFu;
  int rp[S];                          // ring position of each slot
#pragma unroll
  for (int s = 0; s < S; ++s)
    rp[s] = head + s >= kPos ? head + s - kPos : head + s;

  // phase 1: the nearest ring slot holding the candidate's species is
  // its predecessor window; pick the best consecutive candidate there
  unsigned live[S], okm[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    live[s] = (__ballot_sync(kFull, r.sp[s] >= 0) & L.gmask) >> L.gbase;
    okm[s] = 0;
  }
  bool any_ok = false;
  int shift_sel = 0, b_depth = 0, b_ham = 0, b_start = 0, b_rhs = 0;
  float b_score = 0.0f;
  if (sel) {
    // the consecutiveness rule compares a masked or a shifted copy of
    // the predecessor's DNA with the other form of the current one
    const bool mask_pred = (p.kmer_format == 2) == L.fwd;
    bool found = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (found || !live[s]) continue;
      const int4* A = ringA + rp[s] * 32 + L.gbase;
      const int4* B = ringB + rp[s] * 32 + L.gbase;
      int shv = s + 1;
      bool ok_gap = true;
      if (p.dyn_gap) {
        // real window gaps are positive multiples of 3 wherever the
        // result is used, so truncation equals floor here
        const int gapv = (pos_w - B[0].w) / 3;
        ok_gap = gapv >= 1 && gapv <= S;
        shv = gapv < 1 ? 1 : (gapv > S ? S : gapv);
      }
      const int sh3 = 3 * shv;
      const unsigned mask24 = (1u << (24 - sh3)) - 1u;
      const unsigned want = mask_pred ? (nd >> sh3) : (nd & mask24);
      bool aok = false;
      float best = -1.0f;
      int bkey = kBigKey, bi = 0;
      for (unsigned m = live[s]; m; m &= m - 1) {
        const int i = __ffs(m) - 1;
        const int4 e = A[i];
        if (e.x != sp_w) continue;
        found = true;
        const unsigned cd = (unsigned)e.y & 0xFFFFFFu;
        if (!ok_gap || (mask_pred ? (cd & mask24) : (cd >> sh3)) != want)
          continue;
        okm[s] |= 1u << (L.gbase + i);   // this predecessor connects
        // winner = max score, tie -> min (ham,dna) key, tie -> min lane
        const float sc = __int_as_float(e.z);
        if (!aok || sc > best || (sc == best && e.y < bkey)) {
          aok = true;
          best = sc;
          bkey = e.y;
          bi = i;
        }
      }
      if (aok) {
        const int4 b = B[bi];
        any_ok = true;
        shift_sel = shv;
        b_score = best;
        b_depth = A[bi].w;
        b_ham = b.x;
        b_start = b.y;
        b_rhs = b.z;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
    if ((__reduce_or_sync(kFull, okm[s]) >> L.lane) & 1u) r.conn[s] = true;

  // phase 2: the oldest state retires; emit its unconnected paths that
  // are deep enough, ranked by (key, lane)
  {
    constexpr int o = S - 1;
    const int md = ((r.sp[o] >> 30) & 1) ? p.min_cons_euk : p.min_cons;
    const bool emit = r.sp[o] >= 0 && !r.conn[o] && r.depth[o] >= md;
    const unsigned em =
        (__ballot_sync(kFull, emit) & L.gmask) >> L.gbase;
    if (emit) {
      const int4* A = ringA + rp[o] * 32 + L.gbase;
      int rank = 0;
      for (unsigned m = em; m; m &= m - 1) {
        const int i = __ffs(m) - 1;
        const int k2 = A[i].y;
        rank += k2 < r.key[o] || (k2 == r.key[o] && i < L.j);
      }
      const int slot = cnt + rank;
      if (slot < p.block_w)
        path_dp::write_path(p.cols, slot, L.g, p.G, p.block_w, p.compact5,
                            (unsigned)r.start[o], (unsigned)(r.pos[o] + 23),
                            (unsigned)r.ham[o], (unsigned)r.rhs[o],
                            (unsigned)r.rhe[o], r.sp[o] & 0x3FFFFFFF,
                            __float_as_int(r.score[o]));
    }
    cnt += __popc(em);
  }

  // phase 3: the current window's state enters the ring
  float n_score = 0.0f;
  int n_depth, n_ham, n_start, n_rhs;
  if (any_ok) {
    float inc = 0.0f;
    int hinc = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (i < shift_sel) {
        const int h = (rh_w >> (2 * i)) & 3;
        inc = inc + codon_score(h);
        hinc += h;
      }
    }
    n_score = b_score + inc;
    n_depth = b_depth + shift_sel;
    n_ham = b_ham + hinc;
    n_start = b_start;
    n_rhs = b_rhs;
  } else {
    if (sel) {            // an empty candidate's score is never read
#pragma unroll
      for (int c = 0; c < 8; ++c)
        n_score = n_score + codon_score((rh_w >> (2 * c)) & 3);
    }
    n_depth = 1;
    n_ham = key_w >> 24;
    n_start = pos_w;
    n_rhs = rh_w;
  }
#pragma unroll
  for (int s = S - 1; s > 0; --s) {
    r.sp[s] = r.sp[s - 1];
    r.key[s] = r.key[s - 1];
    r.score[s] = r.score[s - 1];
    r.depth[s] = r.depth[s - 1];
    r.ham[s] = r.ham[s - 1];
    r.start[s] = r.start[s - 1];
    r.rhs[s] = r.rhs[s - 1];
    r.rhe[s] = r.rhe[s - 1];
    r.pos[s] = r.pos[s - 1];
    r.conn[s] = r.conn[s - 1];
  }
  r.sp[0] = sel ? sp_w : -1;
  r.key[0] = key_w;
  r.score[0] = n_score;
  r.depth[0] = n_depth;
  r.ham[0] = n_ham;
  r.start[0] = n_start;
  r.rhs[0] = n_rhs;
  r.rhe[0] = rh_w;
  r.pos[0] = pos_w;
  r.conn[0] = false;
  // the new slot 0 takes the position retired one step ago, which no
  // thread reads any more; the __syncwarp orders the writes before the
  // next step's reads
  head = head == 0 ? S : head - 1;
  ringA[head * 32 + L.lane] =
      make_int4(r.sp[0], key_w, __float_as_int(n_score), n_depth);
  ringB[head * 32 + L.lane] = make_int4(n_ham, n_start, n_rhs, pos_w);
  __syncwarp();
}

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
    path_dp_warp_kernel(Params p) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  Lane L;
  L.lane = threadIdx.x & 31;
  const int lanes_per_warp = 32 >> p.log2p;
  const int gw0 = (blockIdx.x * kWarps + warp) * lanes_per_warp;
  if (gw0 >= p.G) return;                 // the whole warp has no lane
  const int grp = L.lane >> p.log2p;
  L.j = L.lane & ((1 << p.log2p) - 1);
  L.gbase = grp << p.log2p;
  L.gmask = p.log2p == 5 ? kFull
                         : ((1u << (1 << p.log2p)) - 1u) << L.gbase;
  L.g = gw0 + grp;
  L.fwd = (L.g % 6) < 3;
  // threads past cap or past the last lane hold no candidate but take
  // part in every warp-wide vote
  const bool mine = L.j < p.cap && L.g < p.G;
  int* tiles = smem + warp * warp_words(S);
  int4* ringA = reinterpret_cast<int4*>(tiles + kTilesWords);
  int4* ringB = ringA + (S + 1) * 32;

  Ring<S> r;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    r.sp[s] = -1;
    r.key[s] = kBigKey;
    r.score[s] = 0.0f;
    r.depth[s] = r.ham[s] = r.start[s] = r.rhs[s] = r.rhe[s] = r.pos[s] = 0;
    r.conn[s] = false;
  }
  int head = 0;                           // ring position of slot 0
  int cnt = 0;                            // emitted paths in this lane

  const int n_tiles = (p.W + kWT - 1) / kWT;
  stage_tile(p, tiles, gw0, 0, L.lane);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    __syncwarp();           // tile t - 1, in the other buffer, is read
    if (t + 1 < n_tiles)
      stage_tile(p, tiles + ((t + 1) & 1) * kTileWords, gw0, (t + 1) * kWT,
                 L.lane);
    cp_async_commit();
    cp_async_wait_prior();  // tile t has landed; t + 1 may be in flight
    __syncwarp();
    const int* cur = tiles + (t & 1) * kTileWords + L.lane;
    const int n = min(kWT, p.W - t * kWT);
    for (int k = 0; k < n; ++k) {
      int sp_w = -1, dna_w = 0, rh_w = 0, ham_w = 0, pos_w = 0;
      if (mine) {
        const int* c = cur + k * kRowWords;
        sp_w = c[0];
        dna_w = c[32];
        rh_w = c[64];
        ham_w = c[96];
        pos_w = c[128];
      }
      step<S>(p, L, r, ringA, ringB, head, cnt, sp_w, dna_w, rh_w, ham_w,
              pos_w);
    }
  }
  for (int k = 0; k < S; ++k)             // flush windows retire the ring
    step<S>(p, L, r, ringA, ringB, head, cnt, -1, 0, 0, 0, 0);

  // empty slots hold 0; valid marks the filled ones
  if (L.g >= p.G) return;
  for (int slot = L.j; slot < p.block_w; slot += 1 << p.log2p)
    path_dp::finish_slot(p.cols, p.valid, slot, L.g, p.G, p.block_w,
                         p.compact5, cnt);
  if (L.j == 0 && cnt > p.block_w) atomicAdd(p.blk_over, cnt - p.block_w);
}

template <int S>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  const int smem = kWarps * warp_words(S) * (int)sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        path_dp_warp_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  path_dp_warp_kernel<S><<<blocks, kWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a cap or max_shift it does not take.
int path_dp_warp_launch(const int* sp, const int* dna, const int* rh,
                        const int* ham, const int* pos, int* cols,
                        unsigned char* valid, int* blk_over, int cap, int G,
                        int W, int S, int block_w, int kmer_format,
                        int dyn_gap, int min_cons, int min_cons_euk,
                        int compact5, void* stream) {
  if (cap < 1 || cap > 32 || S < 1 || S > kMaxShift || G < 1)
    return (int)cudaErrorInvalidValue;
  int log2p = 0;
  while ((1 << log2p) < cap) ++log2p;
  const Params p{{sp, dna, rh, ham, pos}, cols, valid, blk_over,
                 cap, G, W, block_w, kmer_format, dyn_gap, min_cons,
                 min_cons_euk, compact5, log2p};
  const int lanes_per_block = kWarps * (32 >> log2p);
  const int blocks = (G + lanes_per_block - 1) / lanes_per_block;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return launch<1>(p, blocks, st);
    case 2: return launch<2>(p, blocks, st);
    case 3: return launch<3>(p, blocks, st);
    case 4: return launch<4>(p, blocks, st);
    case 5: return launch<5>(p, blocks, st);
    case 6: return launch<6>(p, blocks, st);
    case 7: return launch<7>(p, blocks, st);
    default: return launch<8>(p, blocks, st);
  }
}

}  // extern "C"
