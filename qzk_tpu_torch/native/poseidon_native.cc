// Native host-side Poseidon + Goldilocks kernels for the witness
// generator hot path (the GPU handles the bulk prover workloads; this
// covers the inherently sequential hash-chain levels of witness
// generation, where numpy's per-call overhead dominates).
//
// Reference analog: the witness generators of the plonky2 engine the
// Rust reference delegates to (SURVEY.md §2b "Witness generation").
// Built as a plain C-ABI shared object, loaded via ctypes
// (native/__init__.py); falls back to numpy if unavailable.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <sched.h>
#include <unistd.h>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

static const u64 P = 0xFFFFFFFF00000001ULL;
static const u64 EPS = 0xFFFFFFFFULL; // 2^64 mod p

// Branchless: the carry/borrow conditions are ~50/50 on random field
// data, so data-dependent branches mispredict constantly in the NTT
// butterfly loops; mask arithmetic keeps the pipeline full.
static inline u64 reduce128(u128 x) {
  u64 lo = (u64)x;
  u64 hi = (u64)(x >> 64);
  u64 hi_hi = hi >> 32;
  u64 hi_lo = hi & EPS;
  u64 t = lo - hi_hi;
  t -= (u64)(-(u64)(lo < hi_hi)) & EPS; // wraps correctly mod p
  u64 a = hi_lo * EPS;
  u64 s = t + a;
  s += (u64)(-(u64)(s < t)) & EPS;
  s -= (u64)(-(u64)(s >= P)) & P;
  s -= (u64)(-(u64)(s >= P)) & P;
  return s;
}

static inline u64 gmul(u64 a, u64 b) { return reduce128((u128)a * b); }

static inline u64 gadd(u64 a, u64 b) {
  u64 s = a + b;
  s += (u64)(-(u64)(s < a)) & EPS;
  s -= (u64)(-(u64)(s >= P)) & P;
  return s;
}

static inline u64 gsub(u64 a, u64 b) {
  u64 d = a - b;
  d -= (u64)(-(u64)(a < b)) & EPS;
  return d;
}

static inline u64 sbox7(u64 x) {
  u64 x2 = gmul(x, x);
  u64 x3 = gmul(x2, x);
  u64 x4 = gmul(x2, x2);
  return gmul(x4, x3);
}

// MDS: entries tiny; accumulate in u128.
static inline void mds(const u64 m[12][12], const u64 *in, u64 *out) {
  for (int r = 0; r < 12; ++r) {
    u128 acc = 0;
    for (int c = 0; c < 12; ++c) acc += (u128)m[r][c] * in[c];
    out[r] = reduce128(acc);
  }
}

extern "C" {

// Batched field ops (flat arrays of length n).
void gl_mul(const u64 *a, const u64 *b, u64 *out, long n) {
  for (long i = 0; i < n; ++i) out[i] = gmul(a[i], b[i]);
}
void gl_add(const u64 *a, const u64 *b, u64 *out, long n) {
  for (long i = 0; i < n; ++i) out[i] = gadd(a[i], b[i]);
}
void gl_sub(const u64 *a, const u64 *b, u64 *out, long n) {
  for (long i = 0; i < n; ++i) out[i] = gsub(a[i], b[i]);
}
void gl_mul_sa(u64 s, const u64 *b, u64 *out, long n) {
  for (long i = 0; i < n; ++i) out[i] = gmul(s, b[i]);
}
void gl_add_sa(u64 s, const u64 *b, u64 *out, long n) {
  for (long i = 0; i < n; ++i) out[i] = gadd(s, b[i]);
}
void gl_sub_as(const u64 *a, u64 s, u64 *out, long n) {
  for (long i = 0; i < n; ++i) out[i] = gsub(a[i], s);
}
void gl_sub_sa(u64 s, const u64 *b, u64 *out, long n) {
  for (long i = 0; i < n; ++i) out[i] = gsub(s, b[i]);
}

} // extern "C"

// Fast partial-round tables (the standard Poseidon-paper appendix-B
// optimization: keep an implicit pending dense matrix on coords 1..11
// so each partial round is one sbox + a sparse 23-mul update instead
// of a 144-mul MDS).  Derived exactly mod p by the python loader
// (native/__init__.py:_fast_partial_tables) from the same MDS/round
// constants every caller passes in, and verified bit-exact against the
// numpy oracle by the test suite; layout per round:
//   [c0 (1) | c_hat (11) | v_row (11) | w_hat (11)]  (34 u64)
// followed by the 11x11 dense final matrix (121 u64).
static u64 FAST_T[22 * 34 + 121];
static int FAST_N = 0; // n_partial the tables were built for; 0 = off
// Fingerprint of the Poseidon constants the tables were derived from:
// the fast path is only taken when the caller's constants match (a
// C-ABI caller with different MDS/round constants but the same
// n_partial would otherwise silently hash wrong).
static int FAST_HALF_FULL = -1;
static u64 FAST_M00 = 0, FAST_RC0 = 0;

extern "C" void poseidon_set_fast_tables(const u64 *t, int n_partial,
                                         int half_full, u64 m00, u64 rc0) {
  if (n_partial <= 0 || n_partial > 22) {
    FAST_N = 0;
    return;
  }
  std::memcpy(FAST_T, t, (n_partial * 34 + 121) * sizeof(u64));
  FAST_N = n_partial;
  FAST_HALF_FULL = half_full;
  FAST_M00 = m00;
  FAST_RC0 = rc0;
}

// ---------------------------------------------------------------------------
// 8-way AVX-512 lane-parallel field/Poseidon path (8 independent
// states in structure-of-arrays layout).  Bit-exact mirror of the
// scalar ops above (same wrap/borrow semantics via mask arithmetic);
// selected at runtime when the host supports AVX-512F/DQ and falls
// back to the scalar loops otherwise.  This is host-side SIMD for the
// witness generators and the one-time circuit-build commitment — the
// bulk prover hashing runs on the GPU (ops/csrc/poseidon.cu).
#if defined(__AVX512F__) && defined(__AVX512DQ__)
#define QZK_AVX512 1
#include <immintrin.h>

namespace v8ops {
using v8 = __m512i;

static inline v8 bc(u64 x) { return _mm512_set1_epi64((long long)x); }

static inline v8 vgadd(v8 a, v8 b) {
  const v8 EPSV = bc(EPS), PV = bc(P);
  v8 s = _mm512_add_epi64(a, b);
  __mmask8 c = _mm512_cmplt_epu64_mask(s, a);
  s = _mm512_mask_add_epi64(s, c, s, EPSV);
  __mmask8 ge = _mm512_cmpge_epu64_mask(s, PV);
  s = _mm512_mask_sub_epi64(s, ge, s, PV);
  return s;
}

static inline v8 vgsub(v8 a, v8 b) {
  const v8 EPSV = bc(EPS);
  v8 d = _mm512_sub_epi64(a, b);
  __mmask8 bor = _mm512_cmplt_epu64_mask(a, b);
  d = _mm512_mask_sub_epi64(d, bor, d, EPSV);
  return d;
}

static inline void vmul128(v8 a, v8 b, v8 &hi, v8 &lo) {
  const v8 M32 = bc(0xFFFFFFFFULL);
  v8 a_hi = _mm512_srli_epi64(a, 32);
  v8 b_hi = _mm512_srli_epi64(b, 32);
  v8 lolo = _mm512_mul_epu32(a, b);
  v8 hilo = _mm512_mul_epu32(a_hi, b);
  v8 lohi = _mm512_mul_epu32(a, b_hi);
  v8 hihi = _mm512_mul_epu32(a_hi, b_hi);
  v8 cross = _mm512_add_epi64(
      _mm512_add_epi64(_mm512_srli_epi64(lolo, 32),
                       _mm512_and_si512(hilo, M32)),
      _mm512_and_si512(lohi, M32));
  hi = _mm512_add_epi64(
      _mm512_add_epi64(hihi, _mm512_srli_epi64(hilo, 32)),
      _mm512_add_epi64(_mm512_srli_epi64(lohi, 32),
                       _mm512_srli_epi64(cross, 32)));
  lo = _mm512_or_si512(_mm512_slli_epi64(cross, 32),
                       _mm512_and_si512(lolo, M32));
}

static inline v8 vreduce128(v8 hi, v8 lo) {
  const v8 EPSV = bc(EPS), PV = bc(P);
  v8 hi_hi = _mm512_srli_epi64(hi, 32);
  v8 hi_lo = _mm512_and_si512(hi, EPSV);
  __mmask8 bor = _mm512_cmplt_epu64_mask(lo, hi_hi);
  v8 t = _mm512_sub_epi64(lo, hi_hi);
  t = _mm512_mask_sub_epi64(t, bor, t, EPSV);
  // hi_lo * EPS == (hi_lo << 32) - hi_lo, exact (hi_lo < 2^32)
  v8 a = _mm512_sub_epi64(_mm512_slli_epi64(hi_lo, 32), hi_lo);
  v8 s = _mm512_add_epi64(t, a);
  __mmask8 c = _mm512_cmplt_epu64_mask(s, t);
  s = _mm512_mask_add_epi64(s, c, s, EPSV);
  __mmask8 ge = _mm512_cmpge_epu64_mask(s, PV);
  s = _mm512_mask_sub_epi64(s, ge, s, PV);
  ge = _mm512_cmpge_epu64_mask(s, PV);
  s = _mm512_mask_sub_epi64(s, ge, s, PV);
  return s;
}

static inline v8 vgmul(v8 a, v8 b) {
  v8 hi, lo;
  vmul128(a, b, hi, lo);
  return vreduce128(hi, lo);
}

static inline v8 vsbox7(v8 x) {
  v8 x2 = vgmul(x, x);
  v8 x3 = vgmul(x2, x);
  v8 x4 = vgmul(x2, x2);
  return vgmul(x4, x3);
}

// MDS with tiny entries (max 41 < 2^7): per output row accumulate the
// 12 products as a (hi, lo) u64 pair per lane (sum < 2^74), then one
// reduction — mirrors the scalar u128 accumulation exactly.
static inline void vmds(const u64 m[12][12], const v8 *in, v8 *out) {
  const v8 one = bc(1);
  for (int r = 0; r < 12; ++r) {
    v8 acc_lo = _mm512_setzero_si512();
    v8 acc_hi = _mm512_setzero_si512();
    for (int c = 0; c < 12; ++c) {
      v8 mv = bc(m[r][c]);
      v8 x = in[c];
      v8 p1 = _mm512_mul_epu32(mv, x);  // m * x_lo
      v8 p2 = _mm512_mul_epu32(mv, _mm512_srli_epi64(x, 32));
      v8 lo = _mm512_add_epi64(p1, _mm512_slli_epi64(p2, 32));
      __mmask8 c1 = _mm512_cmplt_epu64_mask(lo, p1);
      v8 hi = _mm512_srli_epi64(p2, 32);
      hi = _mm512_mask_add_epi64(hi, c1, hi, one);
      v8 nlo = _mm512_add_epi64(acc_lo, lo);
      __mmask8 c2 = _mm512_cmplt_epu64_mask(nlo, acc_lo);
      acc_lo = nlo;
      acc_hi = _mm512_add_epi64(acc_hi, hi);
      acc_hi = _mm512_mask_add_epi64(acc_hi, c2, acc_hi, one);
    }
    out[r] = vreduce128(acc_hi, acc_lo);
  }
}

} // namespace v8ops

static inline bool have_avx512() {
  static const bool ok = __builtin_cpu_supports("avx512f") &&
                         __builtin_cpu_supports("avx512dq");
  return ok;
}
#else
static inline bool have_avx512() { return false; }
#endif

static inline void permute_one_naive(u64 *s, const u64 m[12][12],
                                     const u64 *rc, int half_full,
                                     int n_partial) {
  u64 tmp[12];
  int n_rounds = 2 * half_full + n_partial;
  for (int r = 0; r < n_rounds; ++r) {
    const u64 *rcr = rc + r * 12;
    bool full = (r < half_full) || (r >= half_full + n_partial);
    if (full) {
      for (int i = 0; i < 12; ++i) s[i] = sbox7(gadd(s[i], rcr[i]));
    } else {
      for (int i = 0; i < 12; ++i) s[i] = gadd(s[i], rcr[i]);
      s[0] = sbox7(s[0]);
    }
    mds(m, s, tmp);
    std::memcpy(s, tmp, 12 * sizeof(u64));
  }
}

// One Poseidon permutation on a width-12 state (shared core).
static inline void permute_one(u64 *s, const u64 m[12][12], const u64 *rc,
                               int half_full, int n_partial) {
  if (FAST_N != n_partial || FAST_HALF_FULL != half_full ||
      FAST_M00 != m[0][0] || FAST_RC0 != rc[half_full * 12]) {
    permute_one_naive(s, m, rc, half_full, n_partial);
    return;
  }
  u64 tmp[12];
  for (int r = 0; r < half_full; ++r) { // initial full rounds
    const u64 *rcr = rc + r * 12;
    for (int i = 0; i < 12; ++i) s[i] = sbox7(gadd(s[i], rcr[i]));
    mds(m, s, tmp);
    std::memcpy(s, tmp, 12 * sizeof(u64));
  }
  const u64 mu = m[0][0];
  const u64 *t = FAST_T;
  for (int r = 0; r < n_partial; ++r, t += 34) {
    const u64 *ch = t + 1, *vr = t + 12, *wh = t + 23;
    u64 y0 = sbox7(gadd(s[0], t[0]));
    u64 d = gmul(mu, y0);
    for (int i = 0; i < 11; ++i) {
      u64 yi = gadd(s[1 + i], ch[i]);
      s[1 + i] = yi;
      d = gadd(d, gmul(vr[i], yi));
    }
    for (int i = 0; i < 11; ++i)
      s[1 + i] = gadd(s[1 + i], gmul(wh[i], y0));
    s[0] = d;
  }
  u64 shn[11]; // materialize the pending dense matrix once
  for (int i = 0; i < 11; ++i) {
    u64 acc = 0;
    for (int j = 0; j < 11; ++j)
      acc = gadd(acc, gmul(t[i * 11 + j], s[1 + j]));
    shn[i] = acc;
  }
  std::memcpy(s + 1, shn, sizeof shn);
  for (int r = half_full + n_partial; r < 2 * half_full + n_partial;
       ++r) { // final full rounds
    const u64 *rcr = rc + r * 12;
    for (int i = 0; i < 12; ++i) s[i] = sbox7(gadd(s[i], rcr[i]));
    mds(m, s, tmp);
    std::memcpy(s, tmp, 12 * sizeof(u64));
  }
}

#ifdef QZK_AVX512
// 8 permutations at once (states in SoA: s[i] holds element i of 8
// states).  Fast-partial-round factorization identical to permute_one;
// callers must have checked the FAST_* fingerprint first.
static void permute8_fast(v8ops::v8 *s, const u64 m[12][12], const u64 *rc,
                          int half_full, int n_partial) {
  using namespace v8ops;
  v8 tmp[12];
  for (int r = 0; r < half_full; ++r) {
    const u64 *rcr = rc + r * 12;
    for (int i = 0; i < 12; ++i) tmp[i] = vsbox7(vgadd(s[i], bc(rcr[i])));
    vmds(m, tmp, s);
  }
  const u64 mu = m[0][0];
  const u64 *t = FAST_T;
  for (int r = 0; r < n_partial; ++r, t += 34) {
    const u64 *ch = t + 1, *vr = t + 12, *wh = t + 23;
    v8 y0 = vsbox7(vgadd(s[0], bc(t[0])));
    v8 d = vgmul(bc(mu), y0);
    for (int i = 0; i < 11; ++i) {
      v8 yi = vgadd(s[1 + i], bc(ch[i]));
      s[1 + i] = yi;
      d = vgadd(d, vgmul(bc(vr[i]), yi));
    }
    for (int i = 0; i < 11; ++i)
      s[1 + i] = vgadd(s[1 + i], vgmul(bc(wh[i]), y0));
    s[0] = d;
  }
  v8 shn[11];
  for (int i = 0; i < 11; ++i) {
    v8 acc = _mm512_setzero_si512();
    for (int j = 0; j < 11; ++j)
      acc = vgadd(acc, vgmul(bc(t[i * 11 + j]), s[1 + j]));
    shn[i] = acc;
  }
  for (int i = 0; i < 11; ++i) s[1 + i] = shn[i];
  for (int r = half_full + n_partial; r < 2 * half_full + n_partial; ++r) {
    const u64 *rcr = rc + r * 12;
    for (int i = 0; i < 12; ++i) tmp[i] = vsbox7(vgadd(s[i], bc(rcr[i])));
    vmds(m, tmp, s);
  }
}

// 8-way Poseidon-gate witness trace (the shape poseidon_trace and the
// witness-plan executor both record): AoS in (8, 12), swap (8,) ->
// deltas (8, 4), stored (8, stored_w), outputs (8, 12).
static void trace8_core(const u64 *in, const u64 *swp, const u64 m[12][12],
                        const u64 *rc, int half_full, int n_partial,
                        u64 *dl, u64 *st, u64 *out, long stored_w) {
  using namespace v8ops;
  v8 sv[12], tmpv[12], prev[12], inv[12];
  alignas(64) u64 col[8];
  auto ld = [&](const u64 *base, long stride, long off) {
    for (int l = 0; l < 8; ++l) col[l] = base[l * stride + off];
    return _mm512_load_si512((const void *)col);
  };
  auto stv = [&](u64 *base, long stride, long off, v8 x) {
    _mm512_store_si512((void *)col, x);
    for (int l = 0; l < 8; ++l) base[l * stride + off] = col[l];
  };
  for (int i = 0; i < 12; ++i) inv[i] = ld(in, 12, i);
  v8 sw = ld(swp, 1, 0);
  for (int i = 0; i < 4; ++i) {
    v8 d = vgmul(sw, vgsub(inv[i + 4], inv[i]));
    stv(dl, 4, i, d);
    sv[i] = vgadd(inv[i], d);
    sv[i + 4] = vgsub(inv[i + 4], d);
  }
  for (int i = 8; i < 12; ++i) sv[i] = inv[i];
  long sp = 0;
  for (int i = 0; i < 12; ++i) tmpv[i] = vsbox7(vgadd(sv[i], bc(rc[i])));
  vmds(m, tmpv, sv);
  for (int r = 1; r < half_full; ++r) {
    const u64 *rcr = rc + r * 12;
    for (int i = 0; i < 12; ++i) {
      prev[i] = vgadd(sv[i], bc(rcr[i]));
      stv(st, stored_w, sp + i, prev[i]);
      tmpv[i] = vsbox7(prev[i]);
    }
    sp += 12;
    vmds(m, tmpv, sv);
  }
  for (int pr = 0; pr < n_partial; ++pr) {
    const u64 *rcr = rc + (half_full + pr) * 12;
    for (int i = 0; i < 12; ++i) prev[i] = vgadd(sv[i], bc(rcr[i]));
    stv(st, stored_w, sp, prev[0]);
    sp += 1;
    prev[0] = vsbox7(prev[0]);
    vmds(m, prev, sv);
  }
  for (int r = 0; r < half_full; ++r) {
    const u64 *rcr = rc + (half_full + n_partial + r) * 12;
    for (int i = 0; i < 12; ++i) {
      prev[i] = vgadd(sv[i], bc(rcr[i]));
      stv(st, stored_w, sp + i, prev[i]);
      tmpv[i] = vsbox7(prev[i]);
    }
    sp += 12;
    vmds(m, tmpv, sv);
  }
  for (int i = 0; i < 12; ++i) stv(out, 12, i, sv[i]);
}

// AoS (8 states, stride `stride` u64 apart) -> SoA and back.
static inline void load8(const u64 *base, long stride, v8ops::v8 *s,
                         int w = 12) {
  alignas(64) u64 col[8];
  for (int i = 0; i < w; ++i) {
    for (int l = 0; l < 8; ++l) col[l] = base[l * stride + i];
    s[i] = _mm512_load_si512((const void *)col);
  }
}
static inline void store8(u64 *base, long stride, const v8ops::v8 *s,
                          int w = 12) {
  alignas(64) u64 col[8];
  for (int i = 0; i < w; ++i) {
    _mm512_store_si512((void *)col, s[i]);
    for (int l = 0; l < 8; ++l) base[l * stride + i] = col[l];
  }
}
#endif

// True when the 8-way fast path may serve (half_full, n_partial) with
// the caller's constants.
static inline bool fast8_ok(const u64 m[12][12], const u64 *rc,
                            int half_full, int n_partial) {
  return have_avx512() && FAST_N == n_partial &&
         FAST_HALF_FULL == half_full && FAST_M00 == m[0][0] &&
         FAST_RC0 == rc[half_full * 12];
}

extern "C" {

// Batched Poseidon permutation: states (B, 12) in-place.
// mds_m: (12*12), rc: (n_rounds*12), half_full, n_partial as in python.
void poseidon_permute(u64 *states, long B, const u64 *mds_m, const u64 *rc,
                      int half_full, int n_partial) {
  u64 m[12][12];
  for (int r = 0; r < 12; ++r)
    for (int c = 0; c < 12; ++c) m[r][c] = mds_m[r * 12 + c];
  long b = 0;
#ifdef QZK_AVX512
  if (fast8_ok(m, rc, half_full, n_partial)) {
    v8ops::v8 s[12];
    for (; b + 8 <= B; b += 8) {
      load8(states + b * 12, 12, s);
      permute8_fast(s, m, rc, half_full, n_partial);
      store8(states + b * 12, 12, s);
    }
  }
#endif
  for (; b < B; ++b)
    permute_one(states + b * 12, m, rc, half_full, n_partial);
}

// Rate-8 overwrite-mode sponge over rows (hash_n_to_m_no_pad with 4
// outputs): rows (B, w) -> out (B, 4).  ONE call replaces the
// ceil(w/8) separate permute dispatches the python chain makes — the
// host verifier's dominant cost once everything else is batched.
void poseidon_hash_rows(const u64 *rows, long B, long w, const u64 *mds_m,
                        const u64 *rc, int half_full, int n_partial,
                        u64 *out) {
  u64 m[12][12];
  for (int r = 0; r < 12; ++r)
    for (int c = 0; c < 12; ++c) m[r][c] = mds_m[r * 12 + c];
  auto run = [&](long lo, long hi) {
    long b = lo;
#ifdef QZK_AVX512
    if (fast8_ok(m, rc, half_full, n_partial)) {
      v8ops::v8 s[12];
      alignas(64) u64 col[8];
      for (; b + 8 <= hi; b += 8) {
        for (int i = 0; i < 12; ++i) s[i] = _mm512_setzero_si512();
        for (long start = 0; start < w; start += 8) {
          long len = w - start < 8 ? w - start : 8;
          // overwrite-mode absorb: lanes 0..len-1 from each row
          for (long i = 0; i < len; ++i) {
            for (int l = 0; l < 8; ++l)
              col[l] = rows[(b + l) * w + start + i];
            s[i] = _mm512_load_si512((const void *)col);
          }
          permute8_fast(s, m, rc, half_full, n_partial);
        }
        store8(out + b * 4, 4, s, 4);
      }
    }
#endif
    for (; b < hi; ++b) {
      const u64 *in = rows + b * w;
      u64 s[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      for (long start = 0; start < w; start += 8) {
        long len = w - start < 8 ? w - start : 8;
        for (long i = 0; i < len; ++i) s[i] = in[start + i];
        permute_one(s, m, rc, half_full, n_partial);
      }
      std::memcpy(out + b * 4, s, 4 * sizeof(u64));
    }
  };
  long nt = std::thread::hardware_concurrency();
  if (nt > B / 8) nt = B / 8;  // >= 8 rows per thread or stay serial
  if (nt <= 1) {
    run(0, B);
    return;
  }
  std::vector<std::thread> threads;
  long chunk = (B + nt - 1) / nt;
  for (long t = 0; t < nt; ++t) {
    long lo = t * chunk, hi = lo + chunk < B ? lo + chunk : B;
    if (lo < hi) threads.emplace_back(run, lo, hi);
  }
  for (auto &th : threads) th.join();
}

// Duplex-sponge absorb (overwrite mode): write `n` elements into
// state[k], permuting whenever 8 accumulate.  Returns the new pending
// count k' (0..7).  One call absorbs a whole observation batch — the
// python challenger paid one native permute dispatch per 8 elements.
long challenger_absorb(u64 *state, long k, const u64 *elems, long n,
                       const u64 *mds_m, const u64 *rc, int half_full,
                       int n_partial) {
  u64 m[12][12];
  for (int r = 0; r < 12; ++r)
    for (int c = 0; c < 12; ++c) m[r][c] = mds_m[r * 12 + c];
  for (long i = 0; i < n; ++i) {
    state[k++] = elems[i];
    if (k == 8) {
      permute_one(state, m, rc, half_full, n_partial);
      k = 0;
    }
  }
  return k;
}

// Batched Merkle path walk: digests (Q, 4) updated in place through
// `depth` two_to_one compressions with siblings paths (Q, depth, 4)
// and per-query leaf indices idx (Q,) (bit d of idx[q] selects the
// side at level d).  ONE call replaces `depth` hash dispatches.
void poseidon_merkle_walk(u64 *digests, const long long *idx, long Q,
                          const u64 *paths, long depth, const u64 *mds_m,
                          const u64 *rc, int half_full, int n_partial) {
  u64 m[12][12];
  for (int r = 0; r < 12; ++r)
    for (int c = 0; c < 12; ++c) m[r][c] = mds_m[r * 12 + c];
  auto run = [&](long lo, long hi) {
    long q = lo;
#ifdef QZK_AVX512
    // 8 queries per vector: the per-level two_to_one compressions of
    // different queries are independent (the level loop is the only
    // sequential chain), so walk all 8 paths in lockstep.  This is
    // the host verifier's dominant kernel (round-5 profile).
    if (fast8_ok(m, rc, half_full, n_partial)) {
      v8ops::v8 s[12];
      alignas(64) u64 buf[12][8];
      alignas(64) u64 col[8];
      for (; q + 8 <= hi; q += 8) {
        for (long d = 0; d < depth; ++d) {
          for (int l = 0; l < 8; ++l) {
            const u64 *h = digests + (q + l) * 4;
            const u64 *sib = paths + ((q + l) * depth + d) * 4;
            bool odd = (idx[q + l] >> d) & 1;
            const u64 *left = odd ? sib : h;
            const u64 *right = odd ? h : sib;
            for (int i = 0; i < 4; ++i) buf[i][l] = left[i];
            for (int i = 0; i < 4; ++i) buf[4 + i][l] = right[i];
          }
          for (int i = 0; i < 8; ++i)
            s[i] = _mm512_load_si512((const void *)buf[i]);
          for (int i = 8; i < 12; ++i) s[i] = _mm512_setzero_si512();
          permute8_fast(s, m, rc, half_full, n_partial);
          for (int i = 0; i < 4; ++i) {
            _mm512_store_si512((void *)col, s[i]);
            for (int l = 0; l < 8; ++l) digests[(q + l) * 4 + i] = col[l];
          }
        }
      }
    }
#endif
    for (; q < hi; ++q) {
      u64 *h = digests + q * 4;
      long long j = idx[q];
      for (long d = 0; d < depth; ++d) {
        const u64 *sib = paths + (q * depth + d) * 4;
        u64 s[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
        if (j & 1) {
          std::memcpy(s, sib, 4 * sizeof(u64));
          std::memcpy(s + 4, h, 4 * sizeof(u64));
        } else {
          std::memcpy(s, h, 4 * sizeof(u64));
          std::memcpy(s + 4, sib, 4 * sizeof(u64));
        }
        permute_one(s, m, rc, half_full, n_partial);
        std::memcpy(h, s, 4 * sizeof(u64));
        j >>= 1;
      }
    }
  };
  // thread only at widths where the spawn cost amortizes; the
  // verifier's Q=28 stays single-threaded on the 8-way path
  long nt = std::thread::hardware_concurrency();
  if (nt > Q / 64) nt = Q / 64;
  if (nt <= 1) {
    run(0, Q);
    return;
  }
  std::vector<std::thread> threads;
  long chunk = (Q + nt - 1) / nt;
  chunk = (chunk + 7) & ~7L;  // 8-aligned so only the last chunk tails
  for (long t = 0; t < nt; ++t) {
    long lo = t * chunk, hi = lo + chunk < Q ? lo + chunk : Q;
    if (lo < hi) threads.emplace_back(run, lo, hi);
  }
  for (auto &th : threads) th.join();
}

// Poseidon gate witness trace (mirrors gates.poseidon_trace):
//   inputs (B, 12), swap (B,) -> deltas (B, 4), stored (B, 106),
//   outputs (B, 12).
// stored layout: full0 rounds 1..3 (3*12) | partial (n_partial) |
//                full1 rounds 0..3 (4*12).
void poseidon_trace(const u64 *inputs, const u64 *swap, long B,
                    const u64 *mds_m, const u64 *rc, int half_full,
                    int n_partial, u64 *deltas, u64 *stored, u64 *outputs) {
  u64 m[12][12];
  for (int r = 0; r < 12; ++r)
    for (int c = 0; c < 12; ++c) m[r][c] = mds_m[r * 12 + c];
  long stored_w = (half_full - 1) * 12 + n_partial + half_full * 12;
  long b = 0;
#ifdef QZK_AVX512
  if (have_avx512()) {  // naive rounds only — no fast-table dependency
    for (; b + 8 <= B; b += 8)
      trace8_core(inputs + b * 12, swap + b, m, rc, half_full, n_partial,
                  deltas + b * 4, stored + b * stored_w, outputs + b * 12,
                  stored_w);
  }
#endif
  for (; b < B; ++b) {
    const u64 *in = inputs + b * 12;
    u64 *dl = deltas + b * 4;
    u64 *st = stored + b * stored_w;
    u64 *out = outputs + b * 12;
    u64 s[12], tmp[12], pre[12];
    for (int i = 0; i < 4; ++i) dl[i] = gmul(swap[b], gsub(in[i + 4], in[i]));
    for (int i = 0; i < 4; ++i) s[i] = gadd(in[i], dl[i]);
    for (int i = 0; i < 4; ++i) s[i + 4] = gsub(in[i + 4], dl[i]);
    for (int i = 8; i < 12; ++i) s[i] = in[i];
    long sp = 0;
    // round 0 (sbox inputs linear, not stored)
    for (int i = 0; i < 12; ++i) tmp[i] = sbox7(gadd(s[i], rc[i]));
    mds(m, tmp, s);
    // full rounds 1..half_full-1: store sbox inputs
    for (int r = 1; r < half_full; ++r) {
      const u64 *rcr = rc + r * 12;
      for (int i = 0; i < 12; ++i) {
        pre[i] = gadd(s[i], rcr[i]);
        st[sp + i] = pre[i];
        tmp[i] = sbox7(pre[i]);
      }
      sp += 12;
      mds(m, tmp, s);
    }
    // partial rounds: store lane-0 sbox input
    for (int pr = 0; pr < n_partial; ++pr) {
      const u64 *rcr = rc + (half_full + pr) * 12;
      for (int i = 0; i < 12; ++i) pre[i] = gadd(s[i], rcr[i]);
      st[sp++] = pre[0];
      pre[0] = sbox7(pre[0]);
      mds(m, pre, s);
    }
    // second-half full rounds: store all sbox inputs
    for (int r = 0; r < half_full; ++r) {
      const u64 *rcr = rc + (half_full + n_partial + r) * 12;
      for (int i = 0; i < 12; ++i) {
        pre[i] = gadd(s[i], rcr[i]);
        st[sp + i] = pre[i];
        tmp[i] = sbox7(pre[i]);
      }
      sp += 12;
      mds(m, tmp, s);
    }
    std::memcpy(out, s, sizeof(s));
  }
}

} // extern "C"

// ---------------------------------------------------------------------------
// Whole-plan witness generator executor.
//
// Executes every generator batch in one call against the (values,
// known) arrays.  All target ids are pre-resolved union-find ROOT
// indices (python side, plan compile time).  Returns 0 on success or an
// error code with err_info = [code-specific payload]:
//   1 = target read before set        err_info[0] = root id
//   2 = set twice with different vals err_info[0] = root id
//   3 = range check failed            err_info[0] = root id,
//                                     err_info[1] = value, [2] = nbits
// and, on every return, err_info[4] = the threads the run used,
// err_info[5] = the items of the batches it split, err_info[6] = all
// items of the batches it ran (err_info holds 8 slots).
//
// batch_table rows (int64 x 6): [kind, start, count, aux0, aux1, split]
//   kind 0 const:    ids = const_ids[start..+count], vals = const_vals
//   kind 1 arith:    arith_* arrays [start..+count]
//   kind 2 inv:      inv_x / inv_out [start..+count]
//   kind 3 bits:     vals = bits_val[start..+count], nbits = aux0,
//                    bit ids = bits_out[aux1 ..], row-major (count, nbits)
//   kind 4 poseidon: ins = pos_in[start*12..], swap = pos_swap[start..],
//                    internal = pos_internal[start*110..] (canonical
//                    order: deltas | full0 r1..3 | partial | full1),
//                    outs = pos_out[start*12..]; aux0 = items offset
//                    (start indexes ITEMS here, not flat felts)
//   split = 1 marks an arith or poseidon batch whose items may run on
//   several threads: its output roots are pairwise distinct and none is
//   one of its input roots (plonk/witness.py::_NativePlan), so no item
//   reads what another writes and no two write one value.  Such a batch
//   is cut into contiguous ranges (poseidon: of whole 8-item groups),
//   one a thread of the pool below, which its threads claim, the
//   caller's first; each range stops at its first failing item and the lowest
//   failing item of the batch is reported, as the serial walk would.
//   A run holds the pool from its first split batch to its last.
//   max_threads caps the threads (0: the pool's size, 1: the caller's
//   thread alone).
// ---------------------------------------------------------------------------

namespace {

struct WitnessCtx {
  u64 *values;
  unsigned char *known;
};

static inline int wread(WitnessCtx &w, long id, u64 *out) {
  if (!w.known[id]) return 1;
  *out = w.values[id];
  return 0;
}

static inline int wwrite(WitnessCtx &w, long id, u64 v) {
  if (w.known[id]) {
    if (w.values[id] != v) return 2;
    return 0;
  }
  w.values[id] = v;
  w.known[id] = 1;
  return 0;
}

// The plan's arrays and the Poseidon constants every range reads.
struct PlanArgs {
  const long *const_ids;
  const u64 *const_vals;
  const u64 *arith_c0, *arith_c1;
  const long *arith_m0, *arith_m1, *arith_a, *arith_out;
  const long *inv_x, *inv_out;
  const long *bits_val, *bits_out;
  const long *pos_in, *pos_swap, *pos_internal, *pos_out;
  u64 m[12][12];
  const u64 *rc;
  int half_full, n_partial;
  long n_internal, stored_w;
};

// A range's first failing item (its index in the batch) and its error.
struct Fail {
  long item, code, info[3];
};

static inline long fail_at(Fail *f, long item, long code, long id) {
  f->item = item;
  f->code = code;
  f->info[0] = id;
  return code;
}

// Items [lo, hi) of one batch, in order; 0, or the code of the first
// failing item (recorded in *f).
static long run_range(const PlanArgs &p, WitnessCtx &w, const long *row,
                      long lo, long hi, Fail *f) {
  long kind = row[0], start = row[1];
  switch (kind) {
  case 0: // const
    for (long i = lo; i < hi; ++i) {
      long id = p.const_ids[start + i];
      if (int rc_ = wwrite(w, id, p.const_vals[start + i]))
        return fail_at(f, i, rc_, id);
    }
    break;
  case 1: // arith: out = c0 * m0 * m1 + c1 * a
    for (long i = lo; i < hi; ++i) {
      long k = start + i;
      u64 m0, m1, a;
      if (wread(w, p.arith_m0[k], &m0)) return fail_at(f, i, 1, p.arith_m0[k]);
      if (wread(w, p.arith_m1[k], &m1)) return fail_at(f, i, 1, p.arith_m1[k]);
      if (wread(w, p.arith_a[k], &a)) return fail_at(f, i, 1, p.arith_a[k]);
      u64 v = gadd(gmul(p.arith_c0[k], gmul(m0, m1)), gmul(p.arith_c1[k], a));
      if (int rc_ = wwrite(w, p.arith_out[k], v))
        return fail_at(f, i, rc_, p.arith_out[k]);
    }
    break;
  case 2: // inv_or_zero (Fermat; batches are small)
    for (long i = lo; i < hi; ++i) {
      long k = start + i;
      u64 x;
      if (wread(w, p.inv_x[k], &x)) return fail_at(f, i, 1, p.inv_x[k]);
      u64 v = 0;
      if (x != 0) { // x^(p-2)
        u64 result = 1, acc = x;
        u64 e = P - 2;
        while (e) {
          if (e & 1) result = gmul(result, acc);
          acc = gmul(acc, acc);
          e >>= 1;
        }
        v = result;
      }
      if (int rc_ = wwrite(w, p.inv_out[k], v))
        return fail_at(f, i, rc_, p.inv_out[k]);
    }
    break;
  case 3: { // bits: little-endian decomposition + range check
    long nbits = row[3], bstart = row[4];
    for (long i = lo; i < hi; ++i) {
      long vid = p.bits_val[start + i];
      u64 v;
      if (wread(w, vid, &v)) return fail_at(f, i, 1, vid);
      if (nbits < 64 && (v >> nbits) != 0) {
        f->info[1] = (long)v;
        f->info[2] = nbits;
        return fail_at(f, i, 3, vid);
      }
      const long *bids = p.bits_out + bstart + i * nbits;
      for (long b = 0; b < nbits; ++b)
        if (int rc_ = wwrite(w, bids[b], (v >> b) & 1))
          return fail_at(f, i, rc_, bids[b]);
    }
    break;
  }
  case 4: { // poseidon: full trace per item
    const u64(&m)[12][12] = p.m;
    const u64 *rc = p.rc;
    const int half_full = p.half_full, n_partial = p.n_partial;
    const long stored_w = p.stored_w;
    long i0 = lo;
#ifdef QZK_AVX512
    if (have_avx512()) {
      u64 in8[8 * 12], swp8[8], dl8[8 * 4], out8[8 * 12];
      std::vector<u64> st8(8 * stored_w); // this thread's scratch
      for (; i0 + 8 <= hi; i0 += 8) {
        bool ok = true;
        for (int l = 0; l < 8 && ok; ++l) {
          long k = start + i0 + l;
          for (int j = 0; j < 12; ++j)
            if (wread(w, p.pos_in[k * 12 + j], &in8[l * 12 + j])) {
              ok = false;
              break;
            }
          if (ok && wread(w, p.pos_swap[k], &swp8[l])) ok = false;
        }
        if (!ok) break; // scalar tail re-reads and reports the error
        trace8_core(in8, swp8, m, rc, half_full, n_partial, dl8, st8.data(),
                    out8, stored_w);
        for (int l = 0; l < 8; ++l) {
          long i = i0 + l, k = start + i;
          const long *ids = p.pos_internal + k * p.n_internal;
          long sp = 0;
          for (int j = 0; j < 4; ++j, ++sp)
            if (int rc_ = wwrite(w, ids[sp], dl8[l * 4 + j]))
              return fail_at(f, i, rc_, ids[sp]);
          for (long j = 0; j < stored_w; ++j, ++sp)
            if (int rc_ = wwrite(w, ids[sp], st8[l * stored_w + j]))
              return fail_at(f, i, rc_, ids[sp]);
          for (int j = 0; j < 12; ++j)
            if (int rc_ = wwrite(w, p.pos_out[k * 12 + j], out8[l * 12 + j]))
              return fail_at(f, i, rc_, p.pos_out[k * 12 + j]);
        }
      }
    }
#endif
    for (long i = i0; i < hi; ++i) {
      long k = start + i;
      u64 in[12], swp;
      for (int j = 0; j < 12; ++j)
        if (wread(w, p.pos_in[k * 12 + j], &in[j]))
          return fail_at(f, i, 1, p.pos_in[k * 12 + j]);
      if (wread(w, p.pos_swap[k], &swp)) return fail_at(f, i, 1, p.pos_swap[k]);
      const long *ids = p.pos_internal + k * p.n_internal;
      u64 s[12], tmp[12], pre[12], dl[4];
      long sp = 0;
      for (int j = 0; j < 4; ++j) {
        dl[j] = gmul(swp, gsub(in[j + 4], in[j]));
        if (int rc_ = wwrite(w, ids[sp], dl[j])) return fail_at(f, i, rc_, ids[sp]);
        ++sp;
      }
      for (int j = 0; j < 4; ++j) s[j] = gadd(in[j], dl[j]);
      for (int j = 0; j < 4; ++j) s[j + 4] = gsub(in[j + 4], dl[j]);
      for (int j = 8; j < 12; ++j) s[j] = in[j];
      for (int j = 0; j < 12; ++j) tmp[j] = sbox7(gadd(s[j], rc[j]));
      mds(m, tmp, s);
      for (int r = 1; r < half_full; ++r) {
        const u64 *rcr = rc + r * 12;
        for (int j = 0; j < 12; ++j) {
          pre[j] = gadd(s[j], rcr[j]);
          if (int rc_ = wwrite(w, ids[sp], pre[j])) return fail_at(f, i, rc_, ids[sp]);
          ++sp;
          tmp[j] = sbox7(pre[j]);
        }
        mds(m, tmp, s);
      }
      for (int pr = 0; pr < n_partial; ++pr) {
        const u64 *rcr = rc + (half_full + pr) * 12;
        for (int j = 0; j < 12; ++j) pre[j] = gadd(s[j], rcr[j]);
        if (int rc_ = wwrite(w, ids[sp], pre[0])) return fail_at(f, i, rc_, ids[sp]);
        ++sp;
        pre[0] = sbox7(pre[0]);
        mds(m, pre, s);
      }
      for (int r = 0; r < half_full; ++r) {
        const u64 *rcr = rc + (half_full + n_partial + r) * 12;
        for (int j = 0; j < 12; ++j) {
          pre[j] = gadd(s[j], rcr[j]);
          if (int rc_ = wwrite(w, ids[sp], pre[j])) return fail_at(f, i, rc_, ids[sp]);
          ++sp;
          tmp[j] = sbox7(pre[j]);
        }
        mds(m, tmp, s);
      }
      for (int j = 0; j < 12; ++j)
        if (int rc_ = wwrite(w, p.pos_out[k * 12 + j], s[j]))
          return fail_at(f, i, rc_, p.pos_out[k * 12 + j]);
    }
    break;
  }
  }
  return 0;
}

static inline void cpu_relax() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#endif
}

// The host threads the wide batches of a witness plan run on: created
// at first use, never freed, at most MAX_THREADS with the caller's and
// at most half of the cores this process may run on.  One run holds it
// at a time (a try-lock: a run that finds it held runs alone).  A batch
// is cut into one range a thread, and each thread, the caller's first,
// claims the next range not yet taken: a worker that is asleep or
// descheduled when the batch starts holds nothing up, its range going
// to a thread that is running.  While a run holds the pool the workers
// wait between batches by spinning, then yielding; once the run lets it
// go they sleep on a condition variable until the next run takes it.
class WitnessPool {
public:
  static constexpr int MAX_THREADS = 4;

  // nullptr where the process may use fewer than 4 cores.
  static WitnessPool *instance() {
    static std::mutex mu;
    static WitnessPool *pool = nullptr;
    static pid_t owner = 0;
    std::lock_guard<std::mutex> lk(mu);
    if (owner != getpid()) { // first use, or a forked child: no workers here
      owner = getpid();
      pool = nullptr;
      cpu_set_t set;
      int cores = sched_getaffinity(0, sizeof set, &set) == 0 ? CPU_COUNT(&set) : 1;
      int cap = MAX_THREADS, threads = std::min(cap, cores / 2);
      if (threads >= 2) {
        try {
          pool = new WitnessPool(threads - 1);
        } catch (...) {
          pool = nullptr;
        }
      }
    }
    return pool;
  }

  int size() const { return n_workers_ + 1; }

  bool try_acquire() {
    bool free = false;
    if (!held_.compare_exchange_strong(free, true, std::memory_order_acquire))
      return false;
    {
      std::lock_guard<std::mutex> lk(mu_);
      running_.store(true, std::memory_order_release);
    }
    cv_.notify_all();
    return true;
  }

  void release() {
    running_.store(false, std::memory_order_release);
    held_.store(false, std::memory_order_release);
  }

  // fn(ctx, part) for part in [0, parts) on whichever threads claim
  // them, this one included; returns once every part is done.
  void run(int parts, void (*fn)(void *, int), void *ctx) {
    fn_ = fn;
    ctx_ = ctx;
    finished_.store(0, std::memory_order_relaxed);
    // the job word: (batch sequence << 32) | (parts << 16) | next part
    std::uint64_t seq = (job_.load(std::memory_order_relaxed) >> 32) + 1;
    job_.store(seq << 32 | std::uint64_t(parts) << 16, std::memory_order_release);
    while (claim_and_run()) {
    }
    for (long spins = 0; finished_.load(std::memory_order_acquire) != parts;)
      if (++spins < SPINS) cpu_relax();
      else std::this_thread::yield();
  }

private:
  static constexpr long SPINS = 2000;

  explicit WitnessPool(int n_workers) : n_workers_(n_workers) {
    for (int i = 0; i < n_workers; ++i) std::thread([this] { work(); }).detach();
  }

  // Claims the current batch's next part and runs it; false when none
  // is left to claim.
  bool claim_and_run() {
    std::uint64_t w = job_.load(std::memory_order_acquire);
    for (;;) {
      unsigned next = w & 0xFFFF, parts = (w >> 16) & 0xFFFF;
      if (next >= parts) return false;
      if (job_.compare_exchange_weak(w, w + 1, std::memory_order_acq_rel)) {
        fn_(ctx_, int(next)); // the batch lasts until its parts are done
        finished_.fetch_add(1, std::memory_order_release);
        return true;
      }
    }
  }

  void work() {
    for (;;) {
      if (claim_and_run()) continue;
      std::uint64_t w = job_.load(std::memory_order_acquire);
      for (long spins = 0; job_.load(std::memory_order_acquire) == w;) {
        if (++spins < SPINS) {
          cpu_relax();
        } else if (running_.load(std::memory_order_acquire)) {
          std::this_thread::yield();
        } else {
          std::unique_lock<std::mutex> lk(mu_);
          cv_.wait(lk, [&] {
            return running_.load(std::memory_order_acquire) ||
                   job_.load(std::memory_order_acquire) != w;
          });
          spins = 0;
        }
      }
    }
  }

  const int n_workers_;
  std::atomic<bool> held_{false}, running_{false};
  std::atomic<std::uint64_t> job_{0};
  std::atomic<int> finished_{0};
  std::mutex mu_;
  std::condition_variable cv_;
  // the current batch, published by job_
  void (*fn_)(void *, int) = nullptr;
  void *ctx_ = nullptr;
};

// One split batch: its ranges and what each found.
struct SplitBatch {
  const PlanArgs *p;
  WitnessCtx *w;
  const long *row;
  int parts;
  struct alignas(64) Part {
    Fail fail; // code 0: the range ran through
  } part[WitnessPool::MAX_THREADS];

  static void run_part(void *ctx, int k) {
    SplitBatch &b = *static_cast<SplitBatch *>(ctx);
    long count = b.row[2], lo, hi;
    if (b.row[0] == 4) { // whole 8-item groups, the tail to the last range
      long groups = count / 8;
      lo = 8 * (groups * k / b.parts);
      hi = k + 1 == b.parts ? count : 8 * (groups * (k + 1) / b.parts);
    } else {
      lo = count * k / b.parts;
      hi = count * (k + 1) / b.parts;
    }
    run_range(*b.p, *b.w, b.row, lo, hi, &b.part[k].fail);
  }
};

} // namespace

extern "C" {

long run_witness_plan(
    u64 *values, unsigned char *known,
    const long *batch_table, long n_batches,
    const long *const_ids, const u64 *const_vals,
    const u64 *arith_c0, const u64 *arith_c1, const long *arith_m0,
    const long *arith_m1, const long *arith_a, const long *arith_out,
    const long *inv_x, const long *inv_out,
    const long *bits_val, const long *bits_out,
    const long *pos_in, const long *pos_swap, const long *pos_internal,
    const long *pos_out,
    const u64 *mds_m, const u64 *rc, int half_full, int n_partial,
    int max_threads, long *err_info) {
  WitnessCtx w{values, known};
  PlanArgs p{const_ids, const_vals, arith_c0, arith_c1, arith_m0, arith_m1,
             arith_a, arith_out, inv_x, inv_out, bits_val, bits_out,
             pos_in, pos_swap, pos_internal, pos_out, {}, rc,
             half_full, n_partial, 0, 0};
  for (int r = 0; r < 12; ++r)
    for (int c = 0; c < 12; ++c) p.m[r][c] = mds_m[r * 12 + c];
  p.stored_w = (half_full - 1) * 12 + n_partial + half_full * 12;
  p.n_internal = p.stored_w + 4;

  WitnessPool *pool = nullptr; // held by this run
  bool asked = false;
  int threads = 1;
  long split_items = 0, items = 0;
  auto finish = [&](long code) {
    if (pool) pool->release();
    err_info[4] = threads;
    err_info[5] = split_items;
    err_info[6] = items;
    return code;
  };
  auto splits = [](const long *row) { return row[5] == 1 && (row[0] == 1 || row[0] == 4); };
  long last_split = -1; // the workers sleep again after it
  for (long bi = 0; max_threads != 1 && bi < n_batches; ++bi)
    if (splits(batch_table + bi * 6)) last_split = bi;
  for (long bi = 0; bi < n_batches; ++bi) {
    const long *row = batch_table + bi * 6;
    long kind = row[0], count = row[2];
    if (kind < 0 || kind > 4) {
      err_info[0] = kind;
      return finish(99);
    }
    items += count;
    bool split = bi <= last_split && splits(row);
    if (split && !asked) { // the pool, at the run's first split batch
      asked = true;
      WitnessPool *found = WitnessPool::instance();
      if (found && found->try_acquire()) {
        pool = found;
        threads = max_threads > 0 ? std::min(max_threads, pool->size()) : pool->size();
      }
    }
    Fail f{};
    if (split && threads > 1) {
      SplitBatch b{&p, &w, row, threads, {}};
      pool->run(threads, SplitBatch::run_part, &b);
      split_items += count;
      if (bi == last_split) {
        pool->release();
        pool = nullptr;
      }
      const Fail *first = nullptr;
      for (int k = 0; k < threads; ++k)
        if (b.part[k].fail.code && (!first || b.part[k].fail.item < first->item))
          first = &b.part[k].fail;
      if (!first) continue;
      f = *first;
    } else if (!run_range(p, w, row, 0, count, &f)) {
      continue;
    }
    for (int j = 0; j < 3; ++j) err_info[j] = f.info[j];
    return finish(f.code);
  }
  return finish(0);
}

// ---------------------------------------------------------------------------
// Radix-2 NTT over rows (host fallback for the one-time circuit build
// and CPU-only runs; the prover's NTTs run on the TPU).
// data: (rows, n) row-major, transformed in place per row.
// tw: per-stage twiddle table — stage s (1-based, half = 1<<(s-1))
// occupies tw[half-1 .. 2*half-2], entry j = w_s^j.  Total n-1 entries.

static void ntt_row(u64 *x, long n, int log_n, const u64 *tw) {
  for (long i = 1, j = 0; i < n; ++i) {
    long bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j |= bit;
    if (i < j) {
      u64 t = x[i];
      x[i] = x[j];
      x[j] = t;
    }
  }
  for (int s = 1; s <= log_n; ++s) {
    long half = 1L << (s - 1);
    const u64 *w = tw + (half - 1);
    for (long b = 0; b < n; b += half << 1) {
      for (long j = 0; j < half; ++j) {
        u64 o = gmul(x[b + half + j], w[j]);
        u64 e = x[b + j];
        x[b + j] = gadd(e, o);
        x[b + half + j] = gsub(e, o);
      }
    }
  }
}

void gl_ntt_rows(u64 *data, long rows, long n, const u64 *tw,
                 int n_threads) {
  int log_n = 0;
  while ((1L << log_n) < n) ++log_n;
  if (n_threads <= 1 || rows <= 1) {
    for (long r = 0; r < rows; ++r) ntt_row(data + r * n, n, log_n, tw);
    return;
  }
  std::vector<std::thread> threads;
  long per = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long lo = t * per, hi = lo + per < rows ? lo + per : rows;
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      for (long r = lo; r < hi; ++r) ntt_row(data + r * n, n, log_n, tw);
    });
  }
  for (auto &th : threads) th.join();
}

} // extern "C"
