// The index probe: the AA hash lookup, the candidate window, the
// per-codon hamming filter and the [cap, N] candidate fields of a query
// batch, in one launch.
//
// What it replaces.  No TPU kernel: the JAX package's probe is plain jnp
// (metabuli_work_tpu/ops/match_jax.py::match_kmers_quad), and so was the
// port's torch body (ops/match_torch.py::match_kmers_quad_ref, with
// _hash_search, the window gathers and _hamming_filter), which stays as
// the plain version.  That body launched about 605 device operations a
// batch (about ten elementwise operations for each of the 42 slots of a
// hash row, about ten for each of the 8 codons, each over [N] or
// [cap, N] int64 temporaries) at 20-50 us of host each, so its enqueue
// set the pace of the short-read flows, and its gathers and temporaries
// made it most of the long-read flow's device time.  This kernel
// computes what that body computes, bit for bit (integer work only),
// except that a slot whose candidate is not selected carries 0 in its
// five value fields (the plain body leaves the unselected window entry's
// values there); no consumer reads them, and the streamed accumulators
// always held that convention.
//
// What bounds it on an H100.  Bytes and latency: for each valid query one
// 512-byte hash row (more when the table chains rows), then up to cap
// 16-byte window entries from one place, and 21 bytes a window slot
// written ([cap, N]: bool sel and five int32 fields).  A paired batch of
// about 457,000 slots at cap 20 is about 0.58 GB, 0.17 ms at 3.35 TB/s;
// there is no arithmetic to speak of (8 table lookups a candidate).
//
// Design.
// - A thread a query, 256 a block.  Queries that are not valid and hash
//   misses read nothing but their flag and k-mer: on long reads most
//   slots are padding.
// - The hash lookup is warp-cooperative: for each valid query of the
//   warp in turn (a ballot of the valid flags), the 32 lanes read the
//   query's row together, slot s by lane s % 32, so a row is a few
//   coalesced loads instead of 42 scattered ones; the last hit by (row,
//   slot) order wins, as the plain body's torch.where chain does (a warp
//   max-reduce), and the query's own lane takes its run start and length.
// - Then each thread walks its own window twice: once for the minimum
//   hamming over the candidates of the AA run, once to select by
//   min(2 * min, 7) and write each [cap, N] row, the warp's writes of one
//   row coalesced (consecutive n for one j).  The second walk reads the
//   same entries again from the L1/L2 caches, so cap needs no register
//   array and any cap of the retry ladder runs.
// - Windows read entries of the index viewed as flat [*, 4] int32
//   entries, so the wide [R, 128] rows, the [R, 16] block rows and the
//   [S, 4] entry rows are one address.
// - Fold mode (the streamed range passes): with the accumulators in the
//   place of the outputs, a selected slot ORs sel and adds its fields,
//   and nothing else is written.
// - The overflow count (valid queries whose run exceeds cap) is one
//   warp-aggregated atomicAdd a warp into a counter the caller zeroed.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#ifndef PROBE_HD
#define PROBE_HD __host__ __device__ __forceinline__
#endif

namespace probe {

constexpr int kThreads = 256;
constexpr unsigned long long kM40 = (1ull << 40) - 1;
constexpr int kDnaBits = 24;
constexpr int kDnaMask = (1 << kDnaBits) - 1;
constexpr int kEfMask = (1 << 25) - 1;   // euler-first bits of payload lo

struct Params {
  const long long* qk;          // [N] metamer bits
  const int* qf;                // [N] frames
  const unsigned char* qv;      // [N] valid flags
  long long n;                  // N
  const int* ent;               // flat entries, 4 int32 each
  long long n_ent;              // entries in the buffer
  long long m;                  // entries that exist (a window stops there)
  const int* ht;                // [rows, row_u32] hash rows
  long long rows;
  int row_u32, slots, log2_rows, chain, cap, kmer_format;
  unsigned char ham[64];        // HAMMING_TABLE[(q << 3) | t]
  unsigned char* sel;           // [cap, N] outputs, or the accumulators
  int* hamming;
  int* rh;
  int* taxid;
  int* species;
  int* dna;
  int* overflow;                // scalar counter, zeroed by the caller
};

// The home row of a 40-bit AA part in a table of 2^log2_rows rows.
PROBE_HD unsigned home_row(unsigned long long aa, int log2_rows) {
  const unsigned h = ((unsigned)aa * 0x9E3779B1u) ^
                     ((unsigned)(aa >> 32) * 0x85EBCA6Bu);
  return log2_rows > 0 ? h >> (32 - log2_rows) : 0u;
}

// A hash slot (w0, w1) that holds the AA part: the low 32 bits, then the
// high 8 under the occupancy flag.
PROBE_HD bool slot_hit(int w0, int w1, unsigned long long aa) {
  return (unsigned)w0 == (unsigned)aa &&
         ((unsigned)w1 & 0x1FFu) == ((unsigned)(aa >> 32) | 0x100u);
}

PROBE_HD int run_len(int w1) { return (w1 >> 9) & 0x7FFFFF; }

// An entry whose value halves (v_lo, v_hi) carry the AA part: its high
// 32 bits in v_hi, the low 8 in v_lo's top byte.
PROBE_HD bool entry_hit(int v_lo, int v_hi, unsigned long long aa) {
  return (unsigned)v_hi == (unsigned)(aa >> 8) &&
         ((unsigned)v_lo >> 24) == (unsigned)(aa & 0xFF);
}

// Per-codon hamming of two 24-bit DNA parts: the sum, and the 2-bit
// truncations packed forward (codon i in field i) and reversed (7 - i).
struct Codons {
  int hsum, fwd, rev;
};

PROBE_HD Codons codons(int q_dna, int t_dna, const unsigned char* ham) {
  Codons c{0, 0, 0};
  for (int i = 0; i < 8; ++i) {
    const int qi = (q_dna >> (3 * i)) & 7, ti = (t_dna >> (3 * i)) & 7;
    const int h = ham[(qi << 3) | ti];
    c.hsum += h;
    c.fwd |= (h & 3) << (2 * i);
    c.rev |= (h & 3) << (2 * (7 - i));
  }
  return c;
}

PROBE_HD int taxid_of(int p_lo) { return p_lo & kEfMask; }

PROBE_HD int species_of(int p_lo, int p_hi) {
  return (int)((((unsigned)p_lo >> 25) & 0x7Fu) | ((unsigned)p_hi << 7));
}

// Window slots a valid query walks: j < min(run length, cap) with lo + j
// inside the m entries that exist.
PROBE_HD int window_len(long long lo, int rlen, int cap, long long m) {
  int lim = rlen < cap ? rlen : cap;
  const long long room = m - lo;
  if (room < lim) lim = room > 0 ? (int)room : 0;
  return lim;
}

#ifdef __CUDACC__

__device__ __forceinline__ int4 entry(const Params& p, long long e) {
  e = e < p.n_ent - 1 ? e : p.n_ent - 1;
  return __ldg(reinterpret_cast<const int4*>(p.ent) + (e > 0 ? e : 0));
}

template <bool FOLD>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const __grid_constant__ Params p) {
  __shared__ unsigned char ham[64];
  if (threadIdx.x < 64) ham[threadIdx.x] = p.ham[threadIdx.x];
  __syncthreads();

  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool in = n < p.n;
  const bool valid = in && p.qv[n] != 0;
  const long long k = valid ? p.qk[n] : 0;
  const unsigned long long aa = ((unsigned long long)k >> kDnaBits) & kM40;

  // the hash lookup, a valid query of the warp at a time, all lanes on
  // its row(s); a miss leaves lo = m, rlen = 0
  long long lo = p.m;
  int rlen = 0;
  unsigned todo = __ballot_sync(full, valid);
  while (todo) {
    const int q = __ffs(todo) - 1;
    todo &= todo - 1;
    const unsigned long long qaa = __shfl_sync(full, aa, q);
    const long long home = home_row(qaa, p.log2_rows);
    int best = -1;
    for (int c = 0; c < p.chain; ++c) {
      const long long r = home + c < p.rows - 1 ? home + c : p.rows - 1;
      const int* row = p.ht + r * p.row_u32;
      for (int s = lane; s < p.slots; s += 32)
        if (slot_hit(__ldg(row + 3 * s), __ldg(row + 3 * s + 1), qaa))
          best = c * p.slots + s;
    }
    best = __reduce_max_sync(full, best);
    if (lane == q && best >= 0) {
      const int c = best / p.slots, s = best - c * p.slots;
      const long long r = home + c < p.rows - 1 ? home + c : p.rows - 1;
      const int* row = p.ht + r * p.row_u32;
      lo = __ldg(row + 3 * s + 2);
      rlen = run_len(__ldg(row + 3 * s + 1));
    }
  }

  const unsigned over = __ballot_sync(full, valid && rlen > p.cap);
  if (lane == 0 && over != 0) atomicAdd(p.overflow, __popc(over));

  const int lim = valid ? window_len(lo, rlen, p.cap, p.m) : 0;
  const int q_dna = (int)(k & kDnaMask);
  int min_h = 255;
  for (int j = 0; j < lim; ++j) {
    const int4 e = entry(p, lo + j);
    if (entry_hit(e.x, e.y, aa)) {
      const int h = codons(q_dna, e.x & kDnaMask, ham).hsum;
      min_h = h < min_h ? h : min_h;
    }
  }
  const int cutoff = 2 * min_h < 7 ? 2 * min_h : 7;
  const bool use_fwd = valid && ((p.qf[n] < 3) == (p.kmer_format == 2));

  if (!in) return;
  const int end = FOLD ? lim : p.cap;
  for (int j = 0; j < end; ++j) {
    bool s = false;
    int hs = 0, rh = 0, tx = 0, sp = 0, dn = 0;
    if (j < lim) {
      const int4 e = entry(p, lo + j);
      if (entry_hit(e.x, e.y, aa)) {
        const Codons c = codons(q_dna, e.x & kDnaMask, ham);
        if (c.hsum <= cutoff) {
          s = true;
          hs = c.hsum;
          rh = use_fwd ? c.fwd : c.rev;
          tx = taxid_of(e.z);
          sp = species_of(e.z, e.w);
          dn = e.x & kDnaMask;
        }
      }
    }
    const long long o = (long long)j * p.n + n;
    if (FOLD) {
      if (s) {
        p.sel[o] = 1;
        p.hamming[o] += hs;
        p.rh[o] += rh;
        p.taxid[o] += tx;
        p.species[o] += sp;
        p.dna[o] += dn;
      }
    } else {
      p.sel[o] = s;
      p.hamming[o] = hs;
      p.rh[o] = rh;
      p.taxid[o] = tx;
      p.species[o] = sp;
      p.dna[o] = dn;
    }
  }
}

#endif  // __CUDACC__

}  // namespace probe

#ifdef __CUDACC__

extern "C" {

// Launches the probe on `stream` over N queries (N >= 1).  entries: the
// index as n_ent flat 4-int32 entries (16-byte aligned), of which the
// first m exist; ht: the [rows, row_u32] hash table (row_u32 / 3 slots a
// row) of 2^log2_rows rows visited `chain` rows deep; table: the 64-byte
// HAMMING_TABLE.  fold 0: writes every [cap, N] slot of the outputs;
// fold 1: the outputs are accumulators, and each selected slot ORs sel
// and adds its fields.  Adds the run-length overflow to *overflow.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for shapes or
// options it does not take.
int probe_launch(const long long* qk, const int* qf, const unsigned char* qv,
                 long long n, const int* entries, long long n_ent,
                 long long m, const int* ht, long long rows, int row_u32,
                 int log2_rows, int chain, int cap, int kmer_format,
                 const unsigned char* table, int fold, unsigned char* sel,
                 int* hamming, int* rh, int* taxid, int* species, int* dna,
                 int* overflow, void* stream) {
  const long long blocks = (n + probe::kThreads - 1) / probe::kThreads;
  if (n < 1 || blocks > 0x7fffffffLL || n_ent < 1 || m < 0 || rows < 1 ||
      row_u32 < 3 || log2_rows < 0 || log2_rows > 32 || chain < 0 ||
      cap < 1 || ((uintptr_t)entries & 15) != 0)
    return (int)cudaErrorInvalidValue;
  probe::Params p{};
  p.qk = qk;
  p.qf = qf;
  p.qv = qv;
  p.n = n;
  p.ent = entries;
  p.n_ent = n_ent;
  p.m = m;
  p.ht = ht;
  p.rows = rows;
  p.row_u32 = row_u32;
  p.slots = row_u32 / 3;
  p.log2_rows = log2_rows;
  p.chain = chain;
  p.cap = cap;
  p.kmer_format = kmer_format;
  for (int i = 0; i < 64; ++i) p.ham[i] = table[i];
  p.sel = sel;
  p.hamming = hamming;
  p.rh = rh;
  p.taxid = taxid;
  p.species = species;
  p.dna = dna;
  p.overflow = overflow;
  cudaStream_t st = (cudaStream_t)stream;
  if (fold)
    probe::probe_kernel<true><<<(unsigned)blocks, probe::kThreads, 0, st>>>(p);
  else
    probe::probe_kernel<false><<<(unsigned)blocks, probe::kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
