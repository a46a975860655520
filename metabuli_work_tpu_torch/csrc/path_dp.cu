// Fused candidate rank + consecutive-match path DP + blocked emission,
// block-per-lane variant (used for cap > 32; path_dp_warp.cu takes
// cap <= 32).
//
// Replaces the TPU kernel metabuli_work_tpu/ops/dp_pallas.py::_dp_kernel
// (launched by path_dp_blocked).  It computes, for every read x frame
// lane g, exactly what ops/dp_torch.py's sort_candidates -> path_dp ->
// pack_paths_blocked compute on lane-flipped inputs (the plain version
// is ops/dp_cuda.py::path_dp_blocked_ref), i.e. the reference's
// Taxonomer::getMatchPaths (src/commons/Taxonomer.cpp:487-648).
//
// Design.  Lanes are independent and each lane walks its windows in
// order, so one thread block owns one lane: candidate j of the current
// window is handled by thread j (threads loop when cap > blockDim).  The
// ring of the last S = max_shift windows' states (11 int fields + an f32
// score per candidate) lives in shared memory, or in a global scratch
// slice of this block when S*cap states do not fit; the window loop is
// sequential inside the block, with barriers between its phases.
// Candidates stay unsorted: the predecessor is the first strict score
// max in (ham<<24 | dna, lane) order and emitted paths are ranked by the
// same key, which is the order the stable sort of the plain version
// gives.  Emitted paths go straight to their slot of cols[:, slot, g];
// one block owns a lane, so no atomics are needed there.
//
// What bounds it on an H100.  The inputs are read once (5 int32 fields
// of cap*W per lane) and the outputs are block_w*5 words per lane, so
// the bytes are small; the work is the cap x cap predecessor compare per
// ring slot and window (integer ALU work) plus the barriers of the
// sequential window loop.  At cap > 32 a lane's candidates no longer
// fit one warp, so the block barriers stay; the main path's caps
// (<= 32) go to the warp variant, which has none.
//
// f32: every score is a sum of multiples of 0.5 far below 2^24, so each
// add is exact; the adds still run one at a time in the reference order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "path_dp_common.cuh"

namespace {

using path_dp::codon_score;
using path_dp::kBigKey;

// ring field indices (int32 fields; the score is a separate float array)
enum { F_SP, F_DNA, F_DEPTH, F_HAM, F_START, F_RHS, F_RHE, F_CONN, F_POS,
       F_MD, F_KEY, NF };

struct Params {
  const int* sp;     // [cap, G, W] species (euk flag bit 30), -1 = none
  const int* dna;    // [cap, G, W]
  const int* rh;     // [cap, G, W]
  const int* ham;    // [cap, G, W]
  const int* pos;    // [cap, G, W]
  int* cols;         // [n_cols, block_w, G]
  unsigned char* valid;  // [block_w, G]
  int* blk_over;     // [1], zeroed by the caller
  int* scratch;      // global ring storage when not in shared memory
  int cap, G, W, S, block_w, kmer_format, dyn_gap, min_cons, min_cons_euk,
      compact5, ring_in_smem;
};

__global__ void path_dp_block_kernel(Params p) {
  extern __shared__ int smem[];
  const int g = blockIdx.x;
  const int cap = p.cap, S = p.S, G = p.G, W = p.W;
  const int tid = threadIdx.x, nt = blockDim.x;
  // layout per lane: ring ints [S][NF][cap], ring scores [S][cap],
  // staged next state ints [NF][cap] + score [cap]
  const long long ring_words = (long long)S * (NF + 1) * cap;
  const long long lane_words = ring_words + (long long)(NF + 1) * cap;
  int* base = p.ring_in_smem ? smem : p.scratch + (long long)g * lane_words;
  int* ring = base;
  float* rscore = reinterpret_cast<float*>(base + (long long)S * NF * cap);
  int* nx = base + ring_words;
  float* nscore = reinterpret_cast<float*>(nx + NF * cap);
  __shared__ int s_cnt;      // emitted paths so far in this lane
  __shared__ int s_emit;     // any emission in this window

  auto R = [&](int slot, int f, int i) -> int& {
    return ring[((long long)slot * NF + f) * cap + i];
  };

  for (int i = tid; i < cap; i += nt) {
    for (int s = 0; s < S; ++s) {
      for (int f = 0; f < NF; ++f) R(s, f, i) = 0;
      R(s, F_SP, i) = -1;
      rscore[s * cap + i] = 0.0f;
    }
  }
  if (tid == 0) s_cnt = 0;
  const bool fwd = (g % 6) < 3;
  const int n_steps = W + S;          // + the flush windows
  int rr = 0;                         // ring slot of the current window
  __syncthreads();

  for (int w = 0; w < n_steps; ++w) {
    if (tid == 0) s_emit = 0;
    // phase 1: predecessor choice for every current candidate
    for (int j = tid; j < cap; j += nt) {
      int sp_w = -1, dna_w = 0, rh_w = 0, ham_w = 0, pos_w = 0;
      if (w < W) {
        const long long off = ((long long)j * G + g) * W + w;
        sp_w = p.sp[off];
        dna_w = p.dna[off];
        rh_w = p.rh[off];
        ham_w = p.ham[off];
        pos_w = p.pos[off];
      }
      const bool sel_w = sp_w >= 0;
      bool found = false, any_ok = false;
      int shift_sel = 0, b_depth = 0, b_ham = 0, b_start = 0, b_rhs = 0;
      float b_score = 0.0f;
      for (int s = 0; s < S; ++s) {
        int r = rr - 1 - s + S;
        if (r >= S) r -= S;
        bool has_sp = false;
        for (int i = 0; i < cap; ++i) {
          const int psp = R(r, F_SP, i);
          has_sp |= (psp == sp_w) && (psp >= 0);
        }
        const bool use_s = has_sp && !found && sel_w;
        found |= has_sp;
        if (!use_s) continue;
        int shv = s + 1;
        bool ok_gap = true;
        if (p.dyn_gap) {
          // real window gaps are positive multiples of 3 wherever the
          // result is used, so truncation equals floor here
          const int gapv = (pos_w - R(r, F_POS, 0)) / 3;
          ok_gap = gapv >= 1 && gapv <= S;
          shv = gapv < 1 ? 1 : (gapv > S ? S : gapv);
        }
        if (!ok_gap) continue;
        const int sh3 = 3 * shv;
        const unsigned mask24 = (1u << (24 - sh3)) - 1u;
        const unsigned nd = (unsigned)dna_w;
        bool aok = false;
        float best = -1.0f;
        int bkey = kBigKey, bi = 0;
        for (int i = 0; i < cap; ++i) {
          if (R(r, F_SP, i) != sp_w) continue;
          const unsigned cd = (unsigned)R(r, F_DNA, i);
          bool ok;
          if (p.kmer_format == 2)
            ok = fwd ? ((cd & mask24) == (nd >> sh3))
                     : ((nd & mask24) == (cd >> sh3));
          else
            ok = fwd ? ((cd >> sh3) == (nd & mask24))
                     : ((nd >> sh3) == (cd & mask24));
          if (!ok) continue;
          // this predecessor connects to a later window: mark it
          atomicOr(&R(r, F_CONN, i), 1);
          const float sc = rscore[r * cap + i];
          const int key = R(r, F_KEY, i);
          // winner = max score, tie -> min (ham,dna) key, tie -> min lane
          if (!aok || sc > best || (sc == best && key < bkey)) {
            aok = true;
            best = sc;
            bkey = key;
            bi = i;
          }
        }
        if (aok) {
          any_ok = true;
          shift_sel = shv;
          b_score = best;
          b_depth = R(r, F_DEPTH, bi);
          b_ham = R(r, F_HAM, bi);
          b_start = R(r, F_START, bi);
          b_rhs = R(r, F_RHS, bi);
        }
      }
      // new state of candidate j, staged until the oldest slot retires
      float n_score;
      int n_depth, n_ham, n_start, n_rhs;
      if (any_ok) {
        float inc = 0.0f;
        int hinc = 0;
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
        float sc = 0.0f;
        for (int c = 0; c < 8; ++c) sc = sc + codon_score((rh_w >> (2 * c)) & 3);
        n_score = sc;
        n_depth = 1;
        n_ham = ham_w;
        n_start = pos_w;
        n_rhs = rh_w;
      }
      nx[F_SP * cap + j] = sp_w;
      nx[F_DNA * cap + j] = dna_w;
      nx[F_DEPTH * cap + j] = n_depth;
      nx[F_HAM * cap + j] = n_ham;
      nx[F_START * cap + j] = n_start;
      nx[F_RHS * cap + j] = n_rhs;
      nx[F_RHE * cap + j] = rh_w;
      nx[F_CONN * cap + j] = 0;
      nx[F_POS * cap + j] = pos_w;
      nx[F_MD * cap + j] = ((sp_w >> 30) & 1) ? p.min_cons_euk : p.min_cons;
      nx[F_KEY * cap + j] = sel_w ? ((ham_w << 24) | dna_w) : kBigKey;
      nscore[j] = n_score;
    }
    __syncthreads();

    // phase 2: the oldest state (slot rr) retires; emit its unconnected
    // paths that are deep enough, ranked by (key, lane)
    for (int i = tid; i < cap; i += nt) {
      if (R(rr, F_SP, i) >= 0 && R(rr, F_CONN, i) == 0 &&
          R(rr, F_DEPTH, i) >= R(rr, F_MD, i))
        s_emit = 1;
    }
    __syncthreads();
    if (s_emit) {
      const int base_cnt = s_cnt;
      for (int i = tid; i < cap; i += nt) {
        const bool emit = R(rr, F_SP, i) >= 0 && R(rr, F_CONN, i) == 0 &&
                          R(rr, F_DEPTH, i) >= R(rr, F_MD, i);
        if (!emit) continue;
        const int key = R(rr, F_KEY, i);
        int rank = 0;
        for (int i2 = 0; i2 < cap; ++i2) {
          const bool e2 = R(rr, F_SP, i2) >= 0 && R(rr, F_CONN, i2) == 0 &&
                          R(rr, F_DEPTH, i2) >= R(rr, F_MD, i2);
          const int k2 = R(rr, F_KEY, i2);
          rank += e2 && (k2 < key || (k2 == key && i2 < i));
        }
        const int slot = base_cnt + rank;
        if (slot >= p.block_w) continue;
        path_dp::write_path(
            p.cols, slot, g, G, p.block_w, p.compact5,
            (unsigned)R(rr, F_START, i), (unsigned)(R(rr, F_POS, i) + 23),
            (unsigned)R(rr, F_HAM, i), (unsigned)R(rr, F_RHS, i),
            (unsigned)R(rr, F_RHE, i), R(rr, F_SP, i) & 0x3FFFFFFF,
            __float_as_int(rscore[rr * cap + i]));
      }
      __syncthreads();
      if (tid == 0) {
        int n = 0;
        for (int i = 0; i < cap; ++i)
          n += R(rr, F_SP, i) >= 0 && R(rr, F_CONN, i) == 0 &&
               R(rr, F_DEPTH, i) >= R(rr, F_MD, i);
        s_cnt += n;
      }
    }
    __syncthreads();

    // phase 3: the current window takes the retired slot
    for (int j = tid; j < cap; j += nt) {
      for (int f = 0; f < NF; ++f) R(rr, f, j) = nx[f * cap + j];
      rscore[rr * cap + j] = nscore[j];
    }
    rr = rr + 1 == S ? 0 : rr + 1;
    __syncthreads();
  }

  // empty slots hold 0; valid marks the filled ones
  const int cnt = s_cnt;
  for (int slot = tid; slot < p.block_w; slot += nt)
    path_dp::finish_slot(p.cols, p.valid, slot, g, G, p.block_w, p.compact5,
                         cnt);
  if (tid == 0 && cnt > p.block_w) atomicAdd(p.blk_over, cnt - p.block_w);
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs per block with the ring on chip
// (0 means the ring goes to global scratch).
long long path_dp_block_smem_bytes(int cap, int S) {
  return (long long)(S + 1) * (NF + 1) * cap * 4;
}

// Launches the kernel on `stream`; returns cudaGetLastError().  scratch
// holds G * path_dp_block_smem_bytes / 4 ints when ring_in_smem is 0, else
// may be null.
int path_dp_block_launch(const int* sp, const int* dna, const int* rh,
                         const int* ham, const int* pos, int* cols,
                         unsigned char* valid, int* blk_over, int* scratch,
                         int cap, int G, int W, int S, int block_w,
                         int kmer_format, int dyn_gap, int min_cons,
                         int min_cons_euk, int compact5, int ring_in_smem,
                         int threads, void* stream) {
  Params p{sp, dna, rh, ham, pos, cols, valid, blk_over, scratch,
           cap, G, W, S, block_w, kmer_format, dyn_gap, min_cons,
           min_cons_euk, compact5, ring_in_smem};
  const long long smem =
      ring_in_smem ? path_dp_block_smem_bytes(cap, S) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        path_dp_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  path_dp_block_kernel<<<G, threads, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
