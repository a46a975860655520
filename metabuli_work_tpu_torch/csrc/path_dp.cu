// Fused candidate rank + consecutive-match path DP + blocked emission,
// the variant for cap > 32 (path_dp_warp.cu takes cap <= 32): one warp
// a lane.
//
// Replaces the TPU kernel metabuli_work_tpu/ops/dp_pallas.py::_dp_kernel
// (launched by path_dp_blocked), as path_dp_warp.cu does, and computes
// the same thing: for every read x frame lane g, what ops/dp_torch.py's
// sort_candidates -> path_dp -> pack_paths_blocked compute on
// lane-flipped inputs (the plain version is
// ops/dp_cuda.py::path_dp_blocked_ref), i.e. the reference's
// Taxonomer::getMatchPaths (src/commons/Taxonomer.cpp:487-648).
//
// What bounds it on an H100.  The bytes: every input word is read once
// (5 int32 fields of cap * W a lane), block_w * 5 words a lane are
// written; at cap 84, G 6144, W 36 that is 0.116 ms at 3.35 TB/s.  The
// compares are few: caps above 32 come from many-species databases,
// where a window holds about one candidate a species and a candidate
// meets about one predecessor of its species a window.  What remains is
// the chain of W + S dependent window steps of each lane, so the kernel
// is bound by the latency of a step and by how many lanes run side by
// side, which the shared memory a lane holds sets (about 30 KB at cap
// 84: 7 lanes an SM), and by the staging copies, whose short runs of
// each candidate row share the load/store pipe with the step's
// shared-memory loads.  Tiles of 4 windows at cap 84 balance the two.
//
// Design.
// - One warp owns one lane (a block is one warp); candidate j of a
//   window is handled by thread j % 32 in chunk j / 32.  Nothing waits
//   on another warp: a step is ordered by the warp's ballots and
//   reductions and by __syncwarp, never by a block barrier.
// - Live candidates are compacted: a chunk's ballot of sp >= 0 and a
//   popcount give each live candidate its entry index, in lane order,
//   so entry order is lane order and the tie order holds.  The ring of
//   the last S windows keeps only live entries, S + 1 positions of
//   cap entries (a step writes the position retired one step earlier):
//   A = (species, key, score, next entry of its hash chain),
//   B = (depth, path hamming, start, position), C = (rh start, rh end)
//   and a connection byte.
// - Predecessors are looked up by species: every ring position has a
//   hash table of next_pow2(2 cap) heads keyed by the whole species value
//   (euk flag included), each head (window tag << 12 | entry); entries
//   are pushed with atomicExch as they are written, and a tag that is
//   not the window's marks a stale head, so no table is cleared between
//   windows.  A live candidate walks, nearest window first, only the
//   chain of its species' bucket, and stops at the first window that
//   holds its species, where the reference stops.  The winner is the
//   explicit (max score, min key, min entry) over the chain, since chain
//   order is not entry order.
// - A connected predecessor is marked by a byte store of 1 from the
//   lane's own warp (any number of threads may store the same 1); the
//   step's __syncwarp orders every mark before the oldest window
//   retires.
// - Emission: the retiring window's emitters (unconnected, deep enough)
//   are compacted by ballot and a warp prefix count into a key list;
//   each emitter's rank is the count of emitters before it in (key,
//   entry) order, over the emitters only; the lane's path count grows
//   by the ballots' popcounts.
// - Inputs are staged out of the serial chain: the warp copies the five
//   fields of its lane for a tile of kwt windows global->shared with
//   cp.async (4-byte LDGSTS, any W), double-buffered, so tile t + 1
//   loads while tile t runs.  kwt consecutive threads copy kwt
//   consecutive windows of one candidate row, so each copy instruction
//   reads 32 / kwt contiguous runs; rows are padded so its 32 shared
//   writes land in 32 banks.
// - Shared memory is sized by the cap: a block takes the tiles, the
//   emitter keys and the ring as dynamic shared memory, up to the
//   card's 227 KB (cudaFuncAttributeMaxDynamicSharedMemorySize above 48
//   KB); a tile is 8 windows where the lane keeps within kLaneBudget
//   bytes, else the largest of 4, 2, 1 that fits.  Where the ring cannot
//   fit even beside the smallest tiles (caps of about a thousand and
//   more), it lives in a global scratch slice of each resident block,
//   and the blocks walk the lanes in a grid stride; the same code runs
//   on shared-memory or global pointers (a template argument).
// - Emitted paths go straight to their slot of cols[:, slot, g]; empty
//   slots are zeroed at the end and one atomicAdd per overflowing lane
//   counts blk_over.
// Bit-exactness: the predecessor is the first strict score max in the
// (ham << 24 | dna key, lane) order and emitted paths are ranked by
// (key, lane), which is the order the stable sort of the plain version
// gives; a window's position for the dynamic gap is that of its live
// candidate first in that order, the plain version's sorted row 0.
// Scores are sums of multiples of 0.5 far below 2^24, so each add is
// exact; they still run one at a time in the reference order (built
// with --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#include "path_dp_common.cuh"

namespace {

using path_dp::codon_score;
using path_dp::kBigKey;

constexpr int kFields = 5;             // sp, dna, rh, ham, pos
constexpr int kMaxShift = 8;           // 24-bit DNA codes: shift <= 8 codons
constexpr int kMaxCap = 4096;          // entry indices take 12 bits
constexpr int kEntryBits = 12;
constexpr int kTagMask = (1 << 20) - 1;  // window tags: W + S < 2^20
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kSmemMax = 232448;   // dynamic shared memory a block
constexpr long long kLaneBudget = 32 * 1024;  // 8-window tiles: >= 7 lanes
                                              // an SM

// Shared-memory and scratch layout of one lane for a (cap, S).
struct Plan {
  int kwt;             // windows a staged tile
  int row_words;       // words of one staged window (5 * cap + padding)
  int h_log2;          // hash heads a ring position: 1 << h_log2 >= 2 cap
  int ring_in_smem;    // 0: the ring is in global scratch
  long long smem;      // dynamic shared-memory bytes a block (one lane)
  long long ring;      // ring bytes a lane
};

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) & ~15LL;
}

__host__ __device__ inline long long ring_bytes(int cap, int S, int h_log2) {
  const long long P = S + 1, c = cap;
  return align16(P * c * 16) * 2 + align16(P * c * 8) +
         align16(P * ((long long)1 << h_log2) * 4) + align16(P * c);
}

inline Plan make_plan(int cap, int S) {
  Plan pl{};
  pl.h_log2 = 5;
  while ((1 << pl.h_log2) < 2 * cap) ++pl.h_log2;
  pl.ring = ring_bytes(cap, S, pl.h_log2);
  const long long keys = align16((long long)cap * 4);
  auto tiles = [&](int kwt) {
    // a window row's words leave 32 / kwt in the last bank group
    int rw = kFields * cap;
    rw += ((32 / kwt) - rw % 32 + 32) % 32;
    return (long long)2 * kwt * rw * 4;
  };
  // the ring stays on chip while it fits beside the smallest tiles; then
  // 8 windows a tile if the lane keeps within kLaneBudget, else the
  // largest of 4, 2, 1 that fits the block (short runs cost more than
  // the lanes a larger tile takes from an SM)
  pl.ring_in_smem = tiles(1) + keys + pl.ring <= kSmemMax;
  const long long rest = keys + (pl.ring_in_smem ? pl.ring : 0);
  int kwt = 8;
  if (tiles(8) + rest > kLaneBudget)
    for (kwt = 4; kwt > 1 && tiles(kwt) + rest > kSmemMax; kwt >>= 1) {
    }
  pl.kwt = kwt;
  pl.row_words = (int)(tiles(kwt) / (2 * kwt * 4));
  pl.smem = tiles(kwt) + keys + (pl.ring_in_smem ? pl.ring : 0);
  return pl;
}

struct Params {
  const int* in[kFields];  // [cap, G, W] each: sp (euk flag bit 30, -1 =
                           // none), dna, rh, ham, pos
  int* cols;               // [n_cols, block_w, G]
  unsigned char* valid;    // [block_w, G]
  int* blk_over;           // [1], zeroed by the caller
  char* scratch;           // the rings when not in shared memory
  int cap, G, W, block_w, kmer_format, dyn_gap, min_cons, min_cons_euk,
      compact5;
  Plan pl;
};

// One lane's ring: P = S + 1 positions of cap entries each.
struct Ring {
  int4* A;               // species, key, score bits, next entry (-1: end)
  int4* B;               // depth, path hamming, start, position
  int2* C;               // rh start, rh end
  int* heads;            // (tag << 12 | entry) heads of the hash chains
  unsigned char* conn;   // connected to a later window
  int cap, hmask, hshift;
};

__device__ __forceinline__ Ring ring_at(char* base, int cap, int S,
                                        int h_log2) {
  const long long P = S + 1, c = cap;
  Ring r;
  r.A = reinterpret_cast<int4*>(base);
  base += align16(P * c * 16);
  r.B = reinterpret_cast<int4*>(base);
  base += align16(P * c * 16);
  r.C = reinterpret_cast<int2*>(base);
  base += align16(P * c * 8);
  r.heads = reinterpret_cast<int*>(base);
  base += align16(P * ((long long)1 << h_log2) * 4);
  r.conn = reinterpret_cast<unsigned char*>(base);
  r.cap = cap;
  r.hmask = (1 << h_log2) - 1;
  r.hshift = 32 - h_log2;
  return r;
}

__device__ __forceinline__ int bucket(const Ring& r, int sp) {
  return (int)(((unsigned)sp * 0x9E3779B1u) >> r.hshift) & r.hmask;
}

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

// Issues the copies of windows [t0, t0 + kwt) of lane g into `buf`
// ([kwt][row_words]; field f of candidate j at f * cap + j).  Thread
// (q = lane / kwt, k = lane % kwt) copies window t0 + k of candidate
// rows q, q + 32 / kwt, ...
__device__ __forceinline__ void stage_tile(const Params& p, int* buf, int g,
                                           int t0, int lane) {
  const int kwt = p.pl.kwt, kq = 32 / kwt;
  const int k = lane % kwt;
  if (t0 + k >= p.W) return;
  const long long row = (long long)p.G * p.W;
  const long long off0 = (long long)g * p.W + t0 + k;
  int* dst = buf + k * p.pl.row_words;
  for (int q = lane / kwt; q < p.cap; q += kq) {
    const long long off = q * row + off0;
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      cp_async4(dst + f * p.cap + q, p.in[f] + off);
  }
}

// The warp's view of the ring slots: slot s is window w - 1 - s.
template <int S>
struct Slots {
  int n[S];      // live entries
  int wpos[S];   // position of the window's first live entry in
                 // (key, lane) order
};

// One window step of lane g: every live candidate of window w (none on
// a flush step: cur == nullptr) takes its best predecessor, the oldest
// slot retires (emission), the window's entries enter the ring at
// position `head_new`.  Returns with the warp synchronised.
template <int S>
__device__ __forceinline__ void step(const Params& p, const Ring& R,
                                     Slots<S>& sl, int& head, int& cnt,
                                     int* ekey, const int* cur, int w,
                                     int g, bool fwd, int lane) {
  constexpr int P = S + 1;
  const int cap = p.cap;
  const unsigned lt = (1u << lane) - 1u;
  int rp[S];                           // ring position of each slot
#pragma unroll
  for (int s = 0; s < S; ++s) rp[s] = head + s >= P ? head + s - P : head + s;
  const int pos_new = head == 0 ? S : head - 1;   // retired one step ago
  const int tag_new = (w + 1) & kTagMask;
  const bool mask_pred = (p.kmer_format == 2) == fwd;

  // phase 1: best predecessor of each live candidate, the new entries
  int n_cur = 0;
  int min_key = kBigKey;               // first live entry in (key, lane)
  int min_pos = 0;
  const int n_chunks = cur ? (cap + 31) >> 5 : 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int j = (c << 5) + lane;
    int sp_w = -1, dna_w = 0, rh_w = 0, ham_w = 0, pos_w = 0;
    if (j < cap) {
      sp_w = cur[j];
      dna_w = cur[cap + j];
      rh_w = cur[2 * cap + j];
      ham_w = cur[3 * cap + j];
      pos_w = cur[4 * cap + j];
    }
    const bool sel = sp_w >= 0;
    const unsigned live = __ballot_sync(kFull, sel);
    const int ci = n_cur + __popc(live & lt);
    n_cur += __popc(live);
    const int key_w =
        sel ? (int)(((unsigned)ham_w << 24) | (unsigned)dna_w) : kBigKey;
    const int mk = __reduce_min_sync(kFull, key_w);
    if (mk < min_key) {                // uniform: chunks ascend in lane
      const unsigned first = __reduce_min_sync(
          kFull, sel && key_w == mk ? (unsigned)lane : 32u);
      min_pos = __shfl_sync(kFull, pos_w, (int)first);
      min_key = mk;
    }
    if (!sel) continue;
    const unsigned nd = (unsigned)key_w & 0xFFFFFFu;
    bool found = false, any_ok = false;
    int shift_sel = 0, b_depth = 0, b_ham = 0, b_start = 0, b_rhs = 0;
    float b_score = 0.0f;
    const int h = bucket(R, sp_w);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (found || sl.n[s] == 0) continue;
      const int* heads = R.heads + rp[s] * (R.hmask + 1);
      const int hv = heads[h];
      if ((hv >> kEntryBits) != ((w - s) & kTagMask)) continue;
      int shv = s + 1;
      bool ok_gap = true;
      if (p.dyn_gap) {
        // real window gaps are positive multiples of 3 wherever the
        // result is used, so truncation equals floor here
        const int gapv = (pos_w - sl.wpos[s]) / 3;
        ok_gap = gapv >= 1 && gapv <= S;
        shv = gapv < 1 ? 1 : (gapv > S ? S : gapv);
      }
      const int sh3 = 3 * shv;
      const unsigned mask24 = (1u << (24 - sh3)) - 1u;
      const unsigned want = mask_pred ? (nd >> sh3) : (nd & mask24);
      const int4* A = R.A + rp[s] * cap;
      bool aok = false;
      float best = -1.0f;
      int bkey = kBigKey, bi = 0;
      for (int e = hv & ((1 << kEntryBits) - 1); e >= 0;) {
        const int4 a = A[e];
        if (a.x == sp_w) {
          found = true;
          const unsigned cd = (unsigned)a.y & 0xFFFFFFu;
          if (ok_gap &&
              (mask_pred ? (cd & mask24) : (cd >> sh3)) == want) {
            R.conn[rp[s] * cap + e] = 1;     // connects to a later window
            // winner = max score, tie -> min key, tie -> min entry
            const float sc = __int_as_float(a.z);
            if (!aok || sc > best ||
                (sc == best && (a.y < bkey || (a.y == bkey && e < bi)))) {
              aok = true;
              best = sc;
              bkey = a.y;
              bi = e;
            }
          }
        }
        e = a.w;
      }
      if (aok) {
        const int4 b = R.B[rp[s] * cap + bi];
        any_ok = true;
        shift_sel = shv;
        b_score = best;
        b_depth = b.x;
        b_ham = b.y;
        b_start = b.z;
        b_rhs = R.C[rp[s] * cap + bi].x;
      }
    }
    float n_score = 0.0f;
    int n_depth, n_ham, n_start, n_rhs;
    if (any_ok) {
      float inc = 0.0f;
      int hinc = 0;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (i < shift_sel) {
          const int hh = (rh_w >> (2 * i)) & 3;
          inc = inc + codon_score(hh);
          hinc += hh;
        }
      }
      n_score = b_score + inc;
      n_depth = b_depth + shift_sel;
      n_ham = b_ham + hinc;
      n_start = b_start;
      n_rhs = b_rhs;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        n_score = n_score + codon_score((rh_w >> (2 * k)) & 3);
      n_depth = 1;
      n_ham = key_w >> 24;
      n_start = pos_w;
      n_rhs = rh_w;
    }
    // push the entry onto its species' chain in the new position
    const int old = atomicExch(R.heads + pos_new * (R.hmask + 1) + h,
                               (tag_new << kEntryBits) | ci);
    const int next = (old >> kEntryBits) == tag_new
                         ? (old & ((1 << kEntryBits) - 1)) : -1;
    const int o = pos_new * cap + ci;
    R.A[o] = make_int4(sp_w, key_w, __float_as_int(n_score), next);
    R.B[o] = make_int4(n_depth, n_ham, n_start, pos_w);
    R.C[o] = make_int2(n_rhs, rh_w);
    R.conn[o] = 0;
  }
  __syncwarp();                        // marks and new entries visible

  // phase 2: the oldest slot retires; emit its unconnected entries that
  // are deep enough, ranked by (key, entry) over the emitters
  const int n_old = sl.n[S - 1];
  if (n_old > 0) {
    const int po = rp[S - 1] * cap;
    int n_em = 0;
    for (int i0 = 0; i0 < n_old; i0 += 32) {
      const int i = i0 + lane;
      bool emit = false;
      int key = 0;
      if (i < n_old) {
        const int4 a = R.A[po + i];
        const int md = ((a.x >> 30) & 1) ? p.min_cons_euk : p.min_cons;
        emit = !R.conn[po + i] && R.B[po + i].x >= md;
        key = a.y;
      }
      const unsigned em = __ballot_sync(kFull, emit);
      if (emit) ekey[n_em + __popc(em & lt)] = key;
      n_em += __popc(em);
    }
    if (n_em > 0) {
      __syncwarp();                    // the emitters' keys are written
      int e0 = 0;
      for (int i0 = 0; i0 < n_old; i0 += 32) {
        const int i = i0 + lane;
        bool emit = false;
        int4 a = make_int4(0, 0, 0, 0);
        if (i < n_old) {
          a = R.A[po + i];
          const int md = ((a.x >> 30) & 1) ? p.min_cons_euk : p.min_cons;
          emit = !R.conn[po + i] && R.B[po + i].x >= md;
        }
        const unsigned em = __ballot_sync(kFull, emit);
        if (emit) {
          const int me = e0 + __popc(em & lt);
          int rank = 0;
          for (int e = 0; e < n_em; ++e) {
            const int k2 = ekey[e];
            rank += k2 < a.y || (k2 == a.y && e < me);
          }
          const int slot = cnt + rank;
          if (slot < p.block_w) {
            const int4 b = R.B[po + i];
            const int2 c = R.C[po + i];
            path_dp::write_path(p.cols, slot, g, p.G, p.block_w, p.compact5,
                                (unsigned)b.z, (unsigned)(b.w + 23),
                                (unsigned)b.y, (unsigned)c.x, (unsigned)c.y,
                                a.x & 0x3FFFFFFF, a.z);
          }
        }
        e0 += __popc(em);
      }
      cnt += n_em;
    }
  }

  // the window's entries become slot 0
#pragma unroll
  for (int s = S - 1; s > 0; --s) {
    sl.n[s] = sl.n[s - 1];
    sl.wpos[s] = sl.wpos[s - 1];
  }
  sl.n[0] = n_cur;
  sl.wpos[0] = min_pos;
  head = pos_new;
  __syncwarp();                        // the retired position is free
}

// kOnChip: the ring is in shared memory (then every ring access compiles
// to a shared-memory instruction), else in the block's scratch slice.
template <int S, bool kOnChip>
__global__ void __launch_bounds__(32) path_dp_block_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x;
  const Plan& pl = p.pl;
  const long long tile_words = (long long)pl.kwt * pl.row_words;
  int* tiles = reinterpret_cast<int*>(smem);
  int* ekey = tiles + 2 * tile_words;
  char* ring_base =
      kOnChip
          ? smem + 2 * tile_words * 4 + align16((long long)p.cap * 4)
          : p.scratch + (long long)blockIdx.x * pl.ring;
  const Ring R = ring_at(ring_base, p.cap, S, pl.h_log2);
  const int n_heads = (S + 1) << pl.h_log2;
  const int n_tiles = (p.W + pl.kwt - 1) / pl.kwt;

  for (int g = blockIdx.x; g < p.G; g += gridDim.x) {
    for (int i = lane; i < n_heads; i += 32) R.heads[i] = 0;  // tag 0: none
    Slots<S> sl;
#pragma unroll
    for (int s = 0; s < S; ++s) sl.n[s] = sl.wpos[s] = 0;
    int head = 0, cnt = 0;
    const bool fwd = (g % 6) < 3;
    __syncwarp();

    stage_tile(p, tiles, g, 0, lane);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      __syncwarp();         // tile t - 1, in the other buffer, is read
      if (t + 1 < n_tiles)
        stage_tile(p, tiles + ((t + 1) & 1) * tile_words, g,
                   (t + 1) * pl.kwt, lane);
      cp_async_commit();
      cp_async_wait_prior();  // tile t has landed; t + 1 may be in flight
      __syncwarp();
      const int* buf = tiles + (t & 1) * tile_words;
      const int n = min(pl.kwt, p.W - t * pl.kwt);
      for (int k = 0; k < n; ++k)
        step<S>(p, R, sl, head, cnt, ekey, buf + k * pl.row_words,
                t * pl.kwt + k, g, fwd, lane);
    }
    for (int k = 0; k < S; ++k)      // flush windows retire the ring
      step<S>(p, R, sl, head, cnt, ekey, nullptr, p.W + k, g, fwd, lane);

    // empty slots hold 0; valid marks the filled ones
    for (int slot = lane; slot < p.block_w; slot += 32)
      path_dp::finish_slot(p.cols, p.valid, slot, g, p.G, p.block_w,
                           p.compact5, cnt);
    if (lane == 0 && cnt > p.block_w) atomicAdd(p.blk_over, cnt - p.block_w);
    __syncwarp();
  }
}

template <int S>
int launch(const Params& p, long long scratch_bytes, cudaStream_t stream) {
  const int smem = (int)p.pl.smem;
  auto kernel = p.pl.ring_in_smem ? path_dp_block_kernel<S, true>
                                  : path_dp_block_kernel<S, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = p.G;
  if (!p.pl.ring_in_smem) {
    // one scratch ring a resident block; the blocks stride over lanes
    blocks = scratch_bytes / p.pl.ring;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    if (blocks > p.G) blocks = p.G;
  }
  kernel<<<(unsigned)blocks, 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Global scratch bytes path_dp_block_launch needs for (cap, S) on the
// current device: 0 when the ring fits in shared memory, else one ring a
// block that can be resident at once.  -1 for a cap or S it does not
// take; -2 when the device cannot be queried.
long long path_dp_block_scratch_bytes(int cap, int S) {
  if (cap < 1 || cap > kMaxCap || S < 1 || S > kMaxShift) return -1;
  const Plan pl = make_plan(cap, S);
  if (pl.ring_in_smem) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -2;
  const long long per_sm = (kSmemMax + 1024) / (pl.smem + 1024);
  return pl.ring * sms * (per_sm < 1 ? 1 : per_sm);
}

// 1 when the ring of (cap, S) lives in shared memory, 0 in global
// scratch; the dynamic shared-memory bytes a block and the windows of a
// staged tile go to out[0], out[1].
int path_dp_block_plan(int cap, int S, long long* out) {
  const Plan pl = make_plan(cap, S);
  out[0] = pl.smem;
  out[1] = pl.kwt;
  return pl.ring_in_smem;
}

// Launches the kernel on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take or scratch too
// small.  scratch holds scratch_bytes (path_dp_block_scratch_bytes) or is
// null when that is 0.
int path_dp_block_launch(const int* sp, const int* dna, const int* rh,
                         const int* ham, const int* pos, int* cols,
                         unsigned char* valid, int* blk_over, void* scratch,
                         long long scratch_bytes, int cap, int G, int W,
                         int S, int block_w, int kmer_format, int dyn_gap,
                         int min_cons, int min_cons_euk, int compact5,
                         void* stream) {
  if (cap < 1 || cap > kMaxCap || S < 1 || S > kMaxShift || G < 1 ||
      W < 0 || W + S >= kTagMask)
    return (int)cudaErrorInvalidValue;
  const Params p{{sp, dna, rh, ham, pos}, cols, valid, blk_over,
                 static_cast<char*>(scratch), cap, G, W, block_w,
                 kmer_format, dyn_gap, min_cons, min_cons_euk, compact5,
                 make_plan(cap, S)};
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return launch<1>(p, scratch_bytes, st);
    case 2: return launch<2>(p, scratch_bytes, st);
    case 3: return launch<3>(p, scratch_bytes, st);
    case 4: return launch<4>(p, scratch_bytes, st);
    case 5: return launch<5>(p, scratch_bytes, st);
    case 6: return launch<6>(p, scratch_bytes, st);
    case 7: return launch<7>(p, scratch_bytes, st);
    default: return launch<8>(p, scratch_bytes, st);
  }
}

}  // extern "C"
