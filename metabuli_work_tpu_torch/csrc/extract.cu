// Fused 6-frame query extraction: metamer (or AA-only k-mer) packing,
// window validity, the open-syncmer test, ordered window compaction and
// flattening of one or two mates of a read batch, in one launch.
//
// What it replaces.  No TPU kernel: the JAX package's extraction is plain
// jnp (metabuli_work_tpu/ops/encode_jax.py::extract_batch,
// compact_windows, flatten_batch), and so was the port's torch body
// (ops/encode_torch.py::extract_batch_ref with compact_windows and
// flatten_batch, models/flagship.py::extract_queries_step_ref), which
// stays as the plain version.  That body launched about 706 device
// operations a mate (8 codon steps x 6 frames x the AA part, the DNA
// part and the validity, the s-mer loops, the scatters of the
// compaction, the flattening and the concatenation) at 18-19 us of host
// each, so its enqueue, not the card, set the pace of every flow; this
// kernel is one launch for the batch.  It computes exactly what that
// body computes, bit for bit (integer work only).
//
// What bounds it on an H100.  Bytes: each read base is read once
// (a paired mate of 1,024 rows of 168 bases: 172 KB) and each output
// slot written once, 21 bytes (int64 k-mer, int32 position, frame and
// read id, bool valid).  At w_c = 36 compacted slots a frame that is
// 4.6 MB a mate, 9.3 MB a paired batch: about 3 us at 3.35 TB/s.  The
// arithmetic (a table lookup a codon, k shifts and ors a window, k - s +
// 1 compares for the syncmer) is a few hundred integer operations a
// window, far below the card's rate.
//
// Design.
// - One block a (mate, read, frame) row: B x 6 blocks a mate, both mates
//   in one grid.  Frames are independent (a codon position belongs to
//   exactly one frame of each strand, so its AANUM value is computed
//   once), and on long rows (65,536 bases, ~21,800 windows a frame) six
//   blocks a read keep the SMs busy where 32 reads give only 192 rows.
// - The block walks its frame in tiles of blockDim windows (32-256
//   threads, the frame's window count rounded up to a warp).  Each tile
//   first stages the AANUM values of the blockDim + k - 1 codons it
//   needs in shared memory (one byte each, every codon looked up once
//   in a 128-byte shared table); thread t then builds window t from
//   its k staged codons in registers: the AA part (5 bits a codon, or
//   base 21 in the legacy layout), the 24-bit DNA part, the validity
//   and the syncmer test (a rolling s-mer, leftmost minimum).
// - The reverse frames read the forward row from the read's end: codon
//   j of a reverse frame starts at used + begin - 3 - 3j, and the
//   complement is folded into the reverse half of the table, so no
//   right-aligned copy of the batch exists anywhere.
// - Compaction keeps a frame's valid windows in order: a warp ballot a
//   tile, the warps' counts in shared memory, and a running count across
//   tiles give each kept window its slot; slots past the kept ones are
//   zeroed after the walk, and one atomicAdd a row adds the dropped
//   windows to win_over.
// - Every output goes straight to its slot of the flat, concatenated
//   buffers (part 2 after part 1, mate 2's positions offset by
//   maxCoveredLength(len1) + 3), so nothing is flattened or
//   concatenated afterwards.
// The variants (k 8 metamers or AA-only 8-mers, AA-only 12-mers, the two
// k-mer layouts, syncmer, compaction) are template parameters picked from
// the caller's options.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#ifndef EXTRACT_HD
#define EXTRACT_HD __host__ __device__ __forceinline__
#endif

namespace extract {

constexpr int kMaxThreads = 256;
constexpr int kMaxK = 12;

struct Part {
  const unsigned char* reads;   // [B, lmax] ASCII bases
  const int* lens;              // [B]
  const int* lens1;             // mate 1's lengths (the mate-2 offset) or null
  int lmax, W, wout;            // window slots a frame; slots written a frame
  long long base;               // first flat slot of the part
};

struct Params {
  Part part[2];
  int B, smer_len;
  unsigned char tbl[128];       // AANUM of codon b0b1b2 (2-bit codes):
                                // forward [0, 64), reverse complement [64, 128)
  long long* qk;
  int* qp;
  int* qf;                      // null: frame and read id are not written
  int* qs;
  unsigned char* qv;
  int* win_over;
};

// The scalars of one (read, frame) row, as the plain version computes
// them: maxCoveredLength (used), codons a frame (aa_len), windows (n_win),
// the frame's first base (begin) and seq_end.
struct Row {
  int used, aa_len, n_win, begin, seq_end, aa_max;
  bool fwd;
};

EXTRACT_HD int floor_div3(int x) { return x >= 0 ? x / 3 : -((2 - x) / 3); }

EXTRACT_HD int covered_sub(int len) {
  const int rem = len % 3;
  return rem == 0 ? 3 : (rem == 1 ? 4 : 2);
}

EXTRACT_HD Row make_row(int len, int f, int W, int K) {
  Row r;
  const int rem = len % 3;
  r.used = len - covered_sub(len);
  r.aa_len = floor_div3(r.used);
  r.n_win = r.aa_len - (K - 1);
  r.fwd = f < 3;
  r.begin = r.fwd ? f : (rem - f % 3 + 3) % 3;
  r.seq_end = r.begin + r.used - 1;
  r.aa_max = W + K - 1;
  return r;
}

// 2-bit code of a base (A0 C1 T2 G3, either case), -1 for anything else.
EXTRACT_HD int base_code(unsigned char c) {
  const unsigned v = c | 0x20u;
  const bool ok = v == 'a' || v == 'c' || v == 'g' || v == 't';
  return ok ? (int)((v >> 1) & 3u) : -1;
}

// AANUM value of codon j of the row's frame (scan order), 255 where it is
// invalid or outside the read's covered length.
EXTRACT_HD int codon_value(const unsigned char* row, int lmax, const Row& r,
                           int j, const unsigned char* tbl) {
  if (j < 0 || j >= r.aa_len) return 255;
  const int p = r.fwd ? r.begin + 3 * j : r.used + r.begin - 3 - 3 * j;
  if (p < 0 || p + 2 >= lmax) return 255;
  const int a = base_code(row[p]), b = base_code(row[p + 1]),
            c = base_code(row[p + 2]);
  if ((a | b | c) < 0) return 255;
  return tbl[(r.fwd ? 0 : 64) + ((a << 4) | (b << 2) | c)];
}

// Window w of the row from its K staged codon values s[0..K): the k-mer,
// its query position and its validity.
template <int K, int FMT, bool AA_ONLY, bool SYNC>
EXTRACT_HD void window(const unsigned char* s, int w, const Row& r,
                       int smer_len, long long* kmer, int* pos, bool* valid) {
  uint64_t aa = 0, dna = 0;
  bool ok = true;
  int am[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int an = s[t];
    const bool cv = (an >> 3) <= 20;
    am[t] = cv ? an >> 3 : 0;
    const int nm = cv ? an & 7 : 0;
    if (FMT == 1)
      aa = aa * 21 + (uint64_t)am[t];
    else
      aa |= (uint64_t)am[t] << (5 * (K - 1 - t));
    dna |= (uint64_t)nm << (3 * (K - 1 - t));
    ok = ok && cv;
  }
  *kmer = (long long)(AA_ONLY ? aa : (aa << 24) | (dna & 0xFFFFFFull));
  const int scan = FMT == 1 ? w - (r.aa_max - r.aa_len) : w;
  ok = ok && scan >= 0 && scan < r.n_win;
  if (SYNC) {
    // open syncmer: the leftmost minimal s-mer at offset 0 or K - s
    const uint64_t mask = (1ull << (5 * smer_len)) - 1;
    uint64_t cur = 0, best = ~0ull;
    int arg = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      cur = ((cur << 5) | (uint64_t)am[t]) & mask;
      if (t >= smer_len - 1 && cur < best) {
        best = cur;
        arg = t - smer_len + 1;
      }
    }
    ok = ok && (arg == 0 || arg == K - smer_len);
  }
  long long p;
  if (FMT == 1)
    p = r.fwd ? (long long)r.seq_end - 3LL * (scan + K) + 1
              : r.begin + 3LL * scan;
  else
    p = r.fwd ? r.begin + 3LL * w : (long long)r.seq_end - 3LL * (w + K) + 1;
  *pos = (int)p;
  *valid = ok;
}

#ifdef __CUDACC__

__device__ __forceinline__ void store(const Params& p, long long i,
                                      long long kmer, int pos, bool valid,
                                      int f, int b) {
  p.qk[i] = kmer;
  p.qp[i] = pos;
  p.qv[i] = valid;
  if (p.qf != nullptr) {
    p.qf[i] = f;
    p.qs[i] = b + 1;
  }
}

template <int K, int FMT, bool AA_ONLY, bool SYNC, bool COMPACT>
__global__ void __launch_bounds__(kMaxThreads)
    extract_kernel(const __grid_constant__ Params p) {
  __shared__ unsigned char tbl[128];
  __shared__ unsigned char s[kMaxThreads + kMaxK];
  __shared__ int warp_cnt[kMaxThreads / 32];
  const int rows = p.B * 6;
  const int pi = (int)blockIdx.x >= rows;
  const Part P = pi ? p.part[1] : p.part[0];
  const int rb = (int)blockIdx.x - pi * rows;
  const int b = rb / 6, f = rb - 6 * b;
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 128; i += T) tbl[i] = p.tbl[i];
  const Row r = make_row(P.lens[b], f, P.W, K);
  const unsigned char* row = P.reads + (long long)b * P.lmax;
  int off = 0;
  if (P.lens1 != nullptr) {
    const int l1 = P.lens1[b];
    off = max(l1 - covered_sub(l1), 0) + 3;
  }
  const long long out0 = P.base + (long long)rb * P.wout;
  int kept = 0;                 // valid windows so far (compaction)
  __syncthreads();
  for (int w0 = 0; w0 < P.W; w0 += T) {
    // the codons of scan positions w0 .. w0 + T + K - 2 (the legacy
    // layout scans the codon axis backwards)
    for (int i = tid; i < T + K - 1; i += T) {
      const int x = w0 + i;
      s[i] = (unsigned char)codon_value(row, P.lmax, r,
                                        FMT == 1 ? r.aa_max - 1 - x : x, tbl);
    }
    __syncthreads();
    const int w = w0 + tid;
    long long kmer = 0;
    int pos = 0;
    bool valid = false;
    if (w < P.W)
      window<K, FMT, AA_ONLY, SYNC>(s + tid, w, r, p.smer_len, &kmer, &pos,
                                    &valid);
    if (!COMPACT) {
      if (w < P.W) store(p, out0 + w, kmer, pos + off, valid, f, b);
    } else {
      const unsigned m = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) warp_cnt[warp] = __popc(m);
      __syncthreads();
      int before = kept, total = 0;
      for (int i = 0; i < T / 32; ++i) {
        const int c = warp_cnt[i];
        before += i < warp ? c : 0;
        total += c;
      }
      const int slot = before + __popc(m & ((1u << lane) - 1u));
      if (valid && slot < P.wout)
        store(p, out0 + slot, kmer, pos + off, true, f, b);
      kept += total;
    }
    __syncthreads();
  }
  if (COMPACT) {
    for (int slot = min(kept, P.wout) + tid; slot < P.wout; slot += T)
      store(p, out0 + slot, 0, off, false, f, b);
    if (tid == 0 && kept > P.wout) atomicAdd(p.win_over, kept - P.wout);
  }
}

template <int K, int FMT, bool AA_ONLY, bool SYNC, bool COMPACT>
int launch(const Params& p, int blocks, int threads, cudaStream_t stream) {
  extract_kernel<K, FMT, AA_ONLY, SYNC, COMPACT>
      <<<blocks, threads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int K, int FMT, bool AA_ONLY>
int pick(const Params& p, int syncmer, int compact, int blocks, int threads,
         cudaStream_t stream) {
  if constexpr (FMT == 2) {
    if (syncmer && compact)
      return launch<K, FMT, AA_ONLY, true, true>(p, blocks, threads, stream);
    if (syncmer)
      return launch<K, FMT, AA_ONLY, true, false>(p, blocks, threads, stream);
  }
  return launch<K, FMT, AA_ONLY, false, false>(p, blocks, threads, stream);
}

// k 8: metamers or AA-only 8-mers; k 12: AA-only 12-mers alone
template <int K, int FMT>
int pick(const Params& p, int aa_only, int syncmer, int compact, int blocks,
         int threads, cudaStream_t stream) {
  if constexpr (K == 12) {
    return pick<K, FMT, true>(p, syncmer, compact, blocks, threads, stream);
  } else {
    if (aa_only)
      return pick<K, FMT, true>(p, syncmer, compact, blocks, threads, stream);
    return pick<K, FMT, false>(p, syncmer, compact, blocks, threads, stream);
  }
}

#endif  // __CUDACC__

}  // namespace extract

#ifdef __CUDACC__

extern "C" {

// Launches the kernel on `stream` over one part (reads2 null) or two;
// the second part's positions are offset by mate 1's covered length
// (lens1).  qf and qs null: frame and read id are not written (the
// unflattened [B, 6, W] layout).  compact: keep each frame's valid windows
// in order in its wout slots and add the dropped ones to *win_over (needs
// syncmer and kmer_format 2); otherwise wout is W.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for options or shapes it
// does not take.
int extract_launch(const unsigned char* reads1, const int* lens1, int lmax1,
                   int W1, int wout1, const unsigned char* reads2,
                   const int* lens2, int lmax2, int W2, int wout2, int B,
                   int k, int kmer_format, int aa_only, int syncmer,
                   int smer_len, int compact, const unsigned char* tables,
                   long long* qk, int* qp, int* qf, int* qs,
                   unsigned char* qv, int* win_over, void* stream) {
  const int n_parts = reads2 != nullptr ? 2 : 1;
  const bool bad_sync = syncmer && (smer_len < 1 || smer_len > k);
  const bool bad_compact =
      compact && (!syncmer || kmer_format != 2 || win_over == nullptr);
  if ((k != 8 && !(k == 12 && aa_only)) ||
      (kmer_format != 1 && kmer_format != 2) ||
      B < 1 || (long long)B * 6 * n_parts > 0x7fffffffLL || bad_sync ||
      bad_compact || W1 < 0 || W2 < 0 || wout1 < 0 || wout2 < 0 ||
      (!compact && (wout1 != W1 || (n_parts == 2 && wout2 != W2))))
    return (int)cudaErrorInvalidValue;
  extract::Params p{};
  p.part[0] = {reads1, lens1, nullptr, lmax1, W1, wout1, 0};
  if (n_parts == 2)
    p.part[1] = {reads2, lens2, lens1, lmax2, W2, wout2,
                 (long long)B * 6 * wout1};
  p.B = B;
  p.smer_len = smer_len;
  for (int i = 0; i < 128; ++i) p.tbl[i] = tables[i];
  p.qk = qk;
  p.qp = qp;
  p.qf = qf;
  p.qs = qs;
  p.qv = qv;
  p.win_over = win_over;
  // a thread a window of the widest frame, in whole warps, at most
  // kMaxThreads a block
  const int w_max = n_parts == 2 && W2 > W1 ? W2 : W1;
  const int warps = (w_max + 31) / 32;
  const int threads =
      warps < 1 ? 32
                : (warps * 32 > extract::kMaxThreads ? extract::kMaxThreads
                                                     : warps * 32);
  const int blocks = B * 6 * n_parts;
  cudaStream_t st = (cudaStream_t)stream;
  using extract::pick;
  if (k == 8)
    return kmer_format == 1
               ? pick<8, 1>(p, aa_only, syncmer, compact, blocks, threads, st)
               : pick<8, 2>(p, aa_only, syncmer, compact, blocks, threads, st);
  return kmer_format == 1
             ? pick<12, 1>(p, aa_only, syncmer, compact, blocks, threads, st)
             : pick<12, 2>(p, aa_only, syncmer, compact, blocks, threads, st);
}

}  // extern "C"

#endif  // __CUDACC__
