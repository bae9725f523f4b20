// ensemble_chain.cu — the ensemble rollout's placement chain by hand for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs the chain as an XLA
// device program inside its jitted rollout, one lax.while_loop a tick
// (pivot_tpu/parallel/ensemble/tick.py:720-890, place_cond / place_body,
// vmapped over replicas).  In torch the same loop is a Python loop of
// 25-40 small launches a step, plus a CUDA graph replay of the norm
// snapshot for cost-aware (parallel/ensemble/tick.py::_chain_plain); here
// a tick's chain, every replica, is one launch.
//
// The semantics are _chain_plain's, step for step.  Replica r walks its
// steps j < n_ready[r] (its own count, not the max over replicas); step j
// places task order[r, j] of group g = g_p[r, j], demand d = dem_group[g]:
//
//   * fit[h] = all(avail[r, h] > d) (cost-aware, best-fit) or >= d
//     (first-fit, opportunistic), over the four lanes;
//   * cost-aware: score[h] = cost_rt[az, zone(h)] / (snap[h] ·
//     bw_rt[az, zone(h)]) (+ risk[r, h]), az = az_p[r, j], the bandwidth
//     score_bw[r, az, h] under realtime scoring; snap = ‖avail[r]‖ (raised
//     to w_norm[r] with score exponents) of the chain's CURRENT
//     availability, taken again where bf_p[r, j] differs from the last
//     step's (it starts at −1 each launch); the argmin over all hosts of
//     (fit ? score : +inf);
//   * first-fit: the lowest fitting index; with risk the argmin of
//     (fit ? risk : +inf);
//   * best-fit: the argmin of (fit ? ‖avail − d‖ (+ risk) : +inf);
//   * opportunistic: with risk, fit narrows to its least-risk tier (a NaN
//     least risk fits nothing); n = Σfit, u = fmod(u_p[r, j] + weyl[r], 1),
//     k = min(int64(u · n), n − 1); the fit of rank k in index order, or
//     host 0 where no host has that rank;
//   * an argmin puts NaN first and ties to the lowest host index, as
//     torch's and jnp's argmin do (a host that does not fit may win a tie
//     of +inf keys, as there);
//   * ok = some host fits; then avail[r, h] += −d, pl[r, order] = h and
//     delay[r, order] = cd[r, g, zone(h)]; every other entry of pl / delay
//     is −1 / 0.
//
// Norms are XLA:CPU's: sqrt of the fused chain x0·x0, fma(x1, x1, ·),
// fma(x2, x2, ·), fma(x3, x3, ·) (parallel/ensemble/bill.py::_fma_norms);
// the exponent is glibc's powf as XLA:CPU calls it, the twin of
// parallel/ensemble/libm.py::powf (double arithmetic with fused
// multiply-adds, its 16-entry log2 and 32-entry exp2 tables in
// __constant__ memory, its zero, subnormal, inf and y == 0 rules).
//
// The score tables come as [Z, Z] round trips, RT[a, z] = T[a, z] + T[z, a]
// (or [R, Z, Z] under score exponents, raised by torch once a rollout):
// cost_rt[a, h] is RT[a, zone(h)], the same two operands added once.
//
// What bounds it on this card: a serial chain of steps, each a masked
// reduction over the replica's H hosts followed by a dependent update of
// one row — 16 B and ~10-30 operations a host a step, ~1e-4 of a step's
// time at H = 600 (PERF.md §6 gives the bound).  The latency of one step
// (the scan, two warp reductions, one barrier) times the steps sets the
// time.  This first design is simple and correct; making it fast is for
// a later change.
//
// Layout.  One CTA a replica, 32·W threads; thread t owns the contiguous
// hosts [t·Kt, t·Kt + Kt), Kt = ⌈H / 32W⌉, and is the only thread that
// reads or writes their rows, snapshot entries and risk during the chain,
// so a step needs no barrier for the state.  A warp reduces its (key,
// host) with two redux.sync, writes one slot, and the CTA meets at one
// barrier a step; every warp then reads the W slots and reaches the same
// decision, and the thread that owns the winner updates its row and
// writes pl / delay.  The slots hold two buffers by step parity, so one
// barrier a step is enough (a warp reaches step j + 2's write only after
// step j + 1's barrier, which no warp passes before it has read step j's
// slots).  Opportunistic folds its tier and count into one (key, count)
// slot, resolves the rank's warp from the slots and the rank's lane by a
// warp scan.  Steps are staged in shared memory kChunk at a time.
//
// Two forms (ops/cuda_kernels.py::_chain_config picks the form and W):
//   * kFormShared: the replica's rows (16 B), zones (1 B), snapshot and
//     risk (4 B each, where used) in its CTA's shared memory beside the
//     two [Z, Z] tables — at H = 600, Z = 31 ~24 KB, so R = 1024 replicas
//     of 96 threads run as one resident wave on 132 SMs;
//   * kFormGlobal: past that, the rows stay in place in global memory
//     (L1 / L2), the snapshot in a [R, H] scratch row the wrapper
//     allocates; zones and risk read from their tensors.  W = 32.
//
// Numerics: built with --fmad=false and without fast math, and every
// floating-point operation below is an explicit round-to-nearest
// intrinsic in the plain form's operand order, so the kernel's
// placements, delays and availability equal _chain_plain's bit for bit
// in float32.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kCostAware = 0;
constexpr int kFirstFit = 1;
constexpr int kBestFit = 2;
constexpr int kOpportunistic = 3;
constexpr int kFormShared = 0;    // rows in the CTA's shared memory
constexpr int kFormGlobal = 1;    // rows in place in global memory
constexpr int kChunk = 64;        // steps staged at once
constexpr int kMaxWarps = 32;     // warps of a CTA at most
constexpr int kMaxThreads = 1024; // 32 · kMaxWarps
constexpr int kMaxZones = 256;    // the shared form keeps a zone in a byte
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;  // above every host's key

// Sizing: ops/cuda_kernels.py::_chain_smem_bytes keeps the same formula;
// analysis/kernel_budget.py evaluates these functions from this text and
// holds the two equal.
__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }
// Threads one CTA may run: its __launch_bounds__.
__host__ __device__ inline int max_threads() { return kMaxThreads; }
// The two [Z, Z] score tables (cost-aware only).
__host__ __device__ inline int table_bytes(int Z) {
  return align16(8 * Z * Z);
}
// Two buffers of one 16-byte slot a warp.
__host__ __device__ inline int slot_bytes() { return 32 * kMaxWarps; }
// The staged steps: a float4 demand and five 4-byte words each.
__host__ __device__ inline int stage_bytes() { return 36 * kChunk; }
// A host of the shared form: its four lanes and its zone, its snapshot
// (cost-aware) and its risk (with a risk row).
__host__ __device__ inline int host_bytes(int arm, int risk) {
  const int snap = arm == kCostAware ? 4 : 0;
  const int rk = risk != 0 ? 4 : 0;
  return 17 + snap + rk;
}
__host__ __device__ inline int smem_bytes(int H, int Z, int form, int arm,
                                          int risk) {
  const int tables = arm == kCostAware ? table_bytes(Z) : 0;
  const int state = form == kFormShared ? align16(H * host_bytes(arm, risk)) : 0;
  return slot_bytes() + stage_bytes() + tables + state;
}

// glibc's powf tables (__powf_log2_data: 1/c and log2 c over 16
// subintervals, the log2(1 + r) polynomial; __exp2f_data: 2^(i/32) with
// i << 47 taken off its bits, the 2^r polynomial), libm.py's copies.
__constant__ double kPowfInvc[16] = {
    0x1.661ec79f8f3bep+0, 0x1.571ed4aaf883dp+0, 0x1.49539f0f010b0p+0,
    0x1.3c995b0b80385p+0, 0x1.30d190c8864a5p+0, 0x1.25e227b0b8ea0p+0,
    0x1.1bb4a4a1a343fp+0, 0x1.12358f08ae5bap+0, 0x1.0953f419900a7p+0,
    0x1.0000000000000p+0, 0x1.e608cfd9a47acp-1, 0x1.ca4b31f026aa0p-1,
    0x1.b2036576afce6p-1, 0x1.9c2d163a1aa2dp-1, 0x1.886e6037841edp-1,
    0x1.767dcf5534862p-1};
__constant__ double kPowfLogc[16] = {
    -0x1.efec65b963019p-2, -0x1.b0b6832d4fca4p-2, -0x1.7418b0a1fb77bp-2,
    -0x1.39de91a6dcf7bp-2, -0x1.01d9bf3f2b631p-2, -0x1.97c1d1b3b7af0p-3,
    -0x1.2f9e393af3c9fp-3, -0x1.960cbbf788d5cp-4, -0x1.a6f9db6475fcep-5,
    0x0.0p+0,              0x1.338ca9f24f53dp-4,  0x1.476a9543891bap-3,
    0x1.e840b4ac4e4d2p-3,  0x1.40645f0c6651cp-2,  0x1.88e9c2c1b9ff8p-2,
    0x1.ce0a44eb17bccp-2};
__constant__ unsigned long long kExp2fTab[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};
constexpr double kPowfP0 = 0x1.27616c9496e0bp-2;
constexpr double kPowfP1 = -0x1.71969a075c67ap-2;
constexpr double kPowfP2 = 0x1.ec70a6ca7baddp-2;
constexpr double kPowfP3 = -0x1.7154748bef6c8p-1;
constexpr double kPowfP4 = 0x1.71547652ab82bp+0;
constexpr double kExp2fE0 = 0x1.c6af84b912394p-5;
constexpr double kExp2fE1 = 0x1.ebfce50fac4f3p-3;
constexpr double kExp2fE2 = 0x1.62e42ff0c52d6p-1;
constexpr double kExp2fShift = 0x1.8p+47;
constexpr long long kPowfOff = 0x3F330000;

// glibc's powf(x, y) for x >= 0 as XLA:CPU calls it, libm.py::powf op for
// op: a subnormal base reads as −(23 << 23), a result below the smallest
// normal float flushes to 0, then the x == 0, x == inf and y == 0 rules.
__device__ float powf_twin(float x, float y) {
  long long ix = static_cast<long long>(__float_as_int(x));
  if (ix < 0x00800000) ix = -(23ll << 23);
  const long long tmp = ix - kPowfOff;
  const int i = static_cast<int>((tmp >> 19) & 15);
  const long long top = tmp & -0x800000ll;
  const double z =
      static_cast<double>(__int_as_float(static_cast<int>(ix - top)));
  const double k = static_cast<double>(top >> 23);
  const double r = __fma_rn(z, kPowfInvc[i], -1.0);
  const double y0 = __dadd_rn(kPowfLogc[i], k);
  const double r2 = __dmul_rn(r, r);
  const double a = __fma_rn(r, kPowfP0, kPowfP1);
  const double p = __fma_rn(r, kPowfP2, kPowfP3);
  const double r4 = __dmul_rn(r2, r2);
  double q = __fma_rn(r, kPowfP4, y0);
  q = __fma_rn(p, r2, q);
  const double logx = __fma_rn(a, r4, q);
  const double xd = __dmul_rn(static_cast<double>(y), logx);
  double kd = __dadd_rn(xd, kExp2fShift);
  const unsigned long long ki =
      static_cast<unsigned long long>(__double_as_longlong(kd));
  kd = __dsub_rn(kd, kExp2fShift);
  const double rr = __dsub_rn(xd, kd);
  const unsigned long long sb = kExp2fTab[ki & 31] + (ki << 47);
  const double s = __longlong_as_double(static_cast<long long>(sb));
  const double zc = __fma_rn(rr, kExp2fE0, kExp2fE1);
  const double rr2 = __dmul_rn(rr, rr);
  const double w = __fma_rn(rr, kExp2fE2, 1.0);
  float out = __double2float_rn(__dmul_rn(__fma_rn(zc, rr2, w), s));
  if (out < 0x1p-126f) out = 0.f;
  const float inf = __int_as_float(0x7f800000);
  const bool neg = y < 0.f;
  if (x == 0.f) out = neg ? inf : 0.f;
  if (x == inf) out = neg ? 0.f : inf;
  if (y == 0.f) out = 1.f;
  return out;
}

// ‖x‖ as XLA:CPU computes sqrt(sum(x * x)): x0·x0, then three fused
// multiply-adds, then the root (bill.py::_fma_norms).
__device__ __forceinline__ float fma_norm(float x0, float x1, float x2,
                                          float x3) {
  float acc = __fmul_rn(x0, x0);
  acc = __fmaf_rn(x1, x1, acc);
  acc = __fmaf_rn(x2, x2, acc);
  acc = __fmaf_rn(x3, x3, acc);
  return __fsqrt_rn(acc);
}

__device__ __forceinline__ bool fits(const float4& a, const float4& d,
                                     bool strict) {
  return strict ? (a.x > d.x && a.y > d.y && a.z > d.z && a.w > d.w)
                : (a.x >= d.x && a.y >= d.y && a.z >= d.z && a.w >= d.w);
}

// a += −d, the plain form's x + (−d).
__device__ __forceinline__ float4 decrement(const float4& a,
                                            const float4& d) {
  return make_float4(__fadd_rn(a.x, -d.x), __fadd_rn(a.y, -d.y),
                     __fadd_rn(a.z, -d.z), __fadd_rn(a.w, -d.w));
}

// A value's place in the argmin order as an unsigned key: NaN first (the
// plain form's argmin returns the first NaN), then by value with
// −0.0 == +0.0, so that two keys are equal exactly when the values
// compare equal.  Never kNoKey.  Ties in key go to the lower host index.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.0f));
  const unsigned k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return isnan(v) ? 0u : k;
}

struct Params {
  float4* avail;             // [R, H] rows, updated in place
  const int64_t* g_p;        // [R, T] each: the tick's ordered streams
  const int64_t* az_p;
  const int64_t* bf_p;
  const int64_t* order;
  const float* u_p;          // [R, T], opportunistic
  const int64_t* n_ready;    // [R]
  const float4* dem_group;   // [G]
  const float* cd;           // [R, G, Z]
  const int64_t* host_zone;  // [H]
  const float* cost_zz;      // [Z, Z] or [R, Z, Z] (cost-aware)
  const float* bw_zz;
  const float* risk;         // [R, H] or null
  const float* w_norm;       // [R] or null (cost-aware)
  const float* weyl_rot;     // [R] (opportunistic)
  const float* score_bw;     // [R, Z, H] or null (cost-aware, realtime)
  float* snap_rows;          // [R, H]: the global form's snapshot
  int64_t* pl;               // [R, T]
  float* delay;              // [R, T]
  int R, T, H, G, Z;
  int table_rows;            // 1: [R, Z, Z] tables, 0: one [Z, Z] pair
};

template <int kArm, int kForm>
__global__ void __launch_bounds__(kMaxThreads)
    ensemble_chain_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kShared = kForm == kFormShared;
  constexpr bool kCA = kArm == kCostAware;
  const int r = blockIdx.x;
  const int nthr = blockDim.x;
  const int W = nthr >> 5;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int H = p.H;
  const int T = p.T;
  const int Z = p.Z;
  const bool has_risk = p.risk != nullptr;
  const size_t rH = static_cast<size_t>(r) * H;
  const size_t rT = static_cast<size_t>(r) * T;

  // Shared memory: the slots, the staged steps, the tables, the state.
  uint4* s_slot = reinterpret_cast<uint4*>(smem);  // [2][kMaxWarps]
  float4* s_dem = reinterpret_cast<float4*>(smem + slot_bytes());
  int* s_g = reinterpret_cast<int*>(s_dem + kChunk);
  int* s_az = s_g + kChunk;
  int* s_bf = s_az + kChunk;
  int* s_o = s_bf + kChunk;
  float* s_u = reinterpret_cast<float*>(s_o + kChunk);
  unsigned char* rest = smem + slot_bytes() + stage_bytes();
  float* s_cost = reinterpret_cast<float*>(rest);  // [Z, Z]
  float* s_bw = s_cost + Z * Z;
  unsigned char* state = rest + (kCA ? table_bytes(Z) : 0);

  // The replica's per-host state: rows, snapshot, risk, zones.
  float4* A;
  float* S = nullptr;
  const float* K = nullptr;
  float* s_risk = nullptr;
  uint8_t* s_zone = nullptr;
  if (kShared) {
    A = reinterpret_cast<float4*>(state);
    float* after = reinterpret_cast<float*>(A + H);
    if (kCA) {
      S = after;
      after += H;
    }
    if (has_risk) {
      s_risk = after;
      K = after;
      after += H;
    }
    s_zone = reinterpret_cast<uint8_t*>(after);
  } else {
    A = p.avail + rH;
    if (kCA) S = p.snap_rows + rH;
    if (has_risk) K = p.risk + rH;
  }
  auto zone_of = [&](int h) -> int {
    return kShared ? static_cast<int>(s_zone[h])
                   : static_cast<int>(p.host_zone[h]);
  };

  // Outputs: −1 / 0 everywhere a step does not write.
  int64_t* pl = p.pl + rT;
  float* dl = p.delay + rT;
  for (int j = t; j < T; j += nthr) {
    pl[j] = -1;
    dl[j] = 0.f;
  }
  if (kCA) {
    const size_t off =
        p.table_rows ? static_cast<size_t>(r) * Z * Z : static_cast<size_t>(0);
    for (int i = t; i < Z * Z; i += nthr) {
      s_cost[i] = p.cost_zz[off + i];
      s_bw[i] = p.bw_zz[off + i];
    }
  }
  if (kShared) {
    for (int h = t; h < H; h += nthr) {
      A[h] = p.avail[rH + h];
      s_zone[h] = static_cast<uint8_t>(p.host_zone[h]);
      if (has_risk) s_risk[h] = p.risk[rH + h];
    }
  }
  __syncthreads();

  // This thread's hosts [h0, h1).
  const int Kt = ceil_div(H, nthr);
  const int h0 = min(t * Kt, H);
  const int h1 = min(h0 + Kt, H);
  const long long nr = static_cast<long long>(p.n_ready[r]);
  const int n = nr < T ? static_cast<int>(nr) : T;
  const float inf = __int_as_float(0x7f800000);
  const float w_norm = (kCA && p.w_norm != nullptr) ? p.w_norm[r] : 0.f;
  const float rot = kArm == kOpportunistic ? p.weyl_rot[r] : 0.f;
  int prev_bf = -1;  // the snapshot is 0 until a step opens a bucket
  if (kCA) {
    for (int h = h0; h < h1; ++h) S[h] = 0.f;
  }
  int par = 0;

  // The owner of host h places step jj's task there.
  auto place = [&](int h, int jj, const float4& d) {
    if (h >= h0 && h < h1) {
      A[h] = decrement(A[h], d);
      const int o = s_o[jj];
      pl[o] = h;
      dl[o] = p.cd[(static_cast<size_t>(r) * p.G + s_g[jj]) * Z + zone_of(h)];
    }
  };
  // The CTA's argmin of (key, host), and whether any host fit.
  auto argmin = [&](unsigned key, int host, bool any, unsigned& m, int& hm,
                    bool& ok) {
    m = __reduce_min_sync(kAll, key);
    hm = __reduce_min_sync(kAll, key == m ? host : INT_MAX);
    ok = __any_sync(kAll, any);
    if (W > 1) {
      uint4* s = s_slot + par * kMaxWarps;
      par ^= 1;
      if (lane == 0) {
        s[warp] = make_uint4(m, static_cast<unsigned>(hm), ok ? 1u : 0u, 0u);
      }
      __syncthreads();
      const uint4 v = lane < W ? s[lane]
                               : make_uint4(kNoKey, static_cast<unsigned>(
                                                        INT_MAX), 0u, 0u);
      m = __reduce_min_sync(kAll, v.x);
      hm = __reduce_min_sync(kAll,
                             v.x == m ? static_cast<int>(v.y) : INT_MAX);
      ok = __any_sync(kAll, v.z != 0u);
    }
  };

  for (int j0 = 0; j0 < n; j0 += kChunk) {
    const int jn = min(kChunk, n - j0);
    if (j0 > 0) __syncthreads();  // every warp is done with the last chunk
    for (int i = t; i < jn; i += nthr) {
      const size_t q = rT + j0 + i;
      const int g = static_cast<int>(p.g_p[q]);
      s_g[i] = g;
      s_az[i] = static_cast<int>(p.az_p[q]);
      s_bf[i] = static_cast<int>(p.bf_p[q]);
      s_o[i] = static_cast<int>(p.order[q]);
      s_u[i] = kArm == kOpportunistic ? p.u_p[q] : 0.f;
      s_dem[i] = p.dem_group[g];
    }
    __syncthreads();
    for (int jj = 0; jj < jn; ++jj) {
      const float4 d = s_dem[jj];
      if constexpr (kArm == kCostAware) {
        const int bf = s_bf[jj];
        if (bf != prev_bf) {  // the same branch in every thread
          for (int h = h0; h < h1; ++h) {
            const float4 a = A[h];
            const float nm = fma_norm(a.x, a.y, a.z, a.w);
            S[h] = p.w_norm != nullptr ? powf_twin(nm, w_norm) : nm;
          }
          prev_bf = bf;
        }
        const int az = s_az[jj];
        const float* cost_row = s_cost + az * Z;
        const float* bw_row = s_bw + az * Z;
        const float* sbw = p.score_bw == nullptr
                               ? nullptr
                               : p.score_bw + (rH * Z + static_cast<size_t>(az) * H);
        unsigned key = kNoKey;
        int host = INT_MAX;
        bool any = false;
        for (int h = h0; h < h1; ++h) {
          const float4 a = A[h];
          const bool f = fits(a, d, true);
          const int hz = zone_of(h);
          const float b = sbw != nullptr ? sbw[h] : bw_row[hz];
          float v = __fdiv_rn(cost_row[hz], __fmul_rn(S[h], b));
          if (has_risk) v = __fadd_rn(v, K[h]);
          const unsigned kv = order_key(f ? v : inf);
          if (kv < key) {
            key = kv;
            host = h;
          }
          any = any || f;
        }
        unsigned m;
        int h;
        bool ok;
        argmin(key, host, any, m, h, ok);
        if (ok) place(h, jj, d);
      } else if constexpr (kArm == kFirstFit) {
        if (!has_risk) {
          int first = INT_MAX;
          for (int h = h0; h < h1; ++h) {
            if (fits(A[h], d, false)) {
              first = h;
              break;
            }
          }
          first = __reduce_min_sync(kAll, first);
          if (W > 1) {
            uint4* s = s_slot + par * kMaxWarps;
            par ^= 1;
            if (lane == 0) {
              s[warp] = make_uint4(static_cast<unsigned>(first), 0u, 0u, 0u);
            }
            __syncthreads();
            first = __reduce_min_sync(
                kAll, lane < W ? static_cast<int>(s[lane].x) : INT_MAX);
          }
          if (first != INT_MAX) place(first, jj, d);
        } else {
          unsigned key = kNoKey;
          int host = INT_MAX;
          bool any = false;
          for (int h = h0; h < h1; ++h) {
            const bool f = fits(A[h], d, false);
            const unsigned kv = order_key(f ? K[h] : inf);
            if (kv < key) {
              key = kv;
              host = h;
            }
            any = any || f;
          }
          unsigned m;
          int h;
          bool ok;
          argmin(key, host, any, m, h, ok);
          if (ok) place(h, jj, d);
        }
      } else if constexpr (kArm == kBestFit) {
        unsigned key = kNoKey;
        int host = INT_MAX;
        bool any = false;
        for (int h = h0; h < h1; ++h) {
          const float4 a = A[h];
          const bool f = fits(a, d, true);
          float v = fma_norm(__fsub_rn(a.x, d.x), __fsub_rn(a.y, d.y),
                             __fsub_rn(a.z, d.z), __fsub_rn(a.w, d.w));
          if (has_risk) v = __fadd_rn(v, K[h]);
          const unsigned kv = order_key(f ? v : inf);
          if (kv < key) {
            key = kv;
            host = h;
          }
          any = any || f;
        }
        unsigned m;
        int h;
        bool ok;
        argmin(key, host, any, m, h, ok);
        if (ok) place(h, jj, d);
      } else {  // opportunistic
        // This thread's tier (its least risk key among its fits; one tier
        // without risk) and its members there.
        unsigned key = has_risk ? kNoKey : 0u;
        int cnt = 0;
        for (int h = h0; h < h1; ++h) {
          if (!fits(A[h], d, false)) continue;
          if (has_risk) {
            const unsigned kv = order_key(K[h]);
            if (kv < key) {
              key = kv;
              cnt = 1;
            } else if (kv == key) {
              ++cnt;
            }
          } else {
            ++cnt;
          }
        }
        const unsigned wkey = has_risk ? __reduce_min_sync(kAll, key) : 0u;
        const int wcnt = __reduce_add_sync(kAll, key == wkey ? cnt : 0);
        unsigned tier = wkey;
        int total = wcnt;
        int before = 0;  // the tier's members in warps before this one
        if (W > 1) {
          uint4* s = s_slot + par * kMaxWarps;
          par ^= 1;
          if (lane == 0) s[warp] = make_uint4(wkey, wcnt, 0u, 0u);
          __syncthreads();
          const uint4 v = lane < W ? s[lane] : make_uint4(kNoKey, 0u, 0u, 0u);
          tier = has_risk ? __reduce_min_sync(kAll, v.x) : 0u;
          const int kc = v.x == tier ? static_cast<int>(v.y) : 0;
          total = __reduce_add_sync(kAll, kc);
          before = __reduce_add_sync(kAll, lane < warp ? kc : 0);
        }
        if (has_risk && tier == 0u) total = 0;  // a NaN least risk
        if (total == 0) continue;  // the same branch in every thread
        const float ue = fmodf(__fadd_rn(s_u[jj], rot), 1.0f);
        const long long kk = static_cast<long long>(
            __fmul_rn(ue, __int2float_rn(total)));
        const int k = kk < total - 1 ? static_cast<int>(kk) : total - 1;
        if (k < 0) {  // no host has that rank: host 0, as argmax of none
          place(0, jj, d);
          continue;
        }
        const int mine = wkey == tier ? wcnt : 0;
        if (before <= k && k < before + mine) {  // this warp holds rank k
          const int c = key == tier ? cnt : 0;
          int incl = c;
          for (int o = 1; o < 32; o <<= 1) {
            const int up = __shfl_up_sync(kAll, incl, o);
            if (lane >= o) incl += up;
          }
          int need = k - before - (incl - c);
          if (need >= 0 && need < c) {
            int h = h0;
            for (; h < h1; ++h) {
              if (fits(A[h], d, false) &&
                  (!has_risk || order_key(K[h]) == tier)) {
                if (need == 0) break;
                --need;
              }
            }
            place(h, jj, d);
          }
        }
      }
    }
  }

  if (kShared) {  // the rows back, each by its owner
    for (int h = h0; h < h1; ++h) p.avail[rH + h] = A[h];
  }
}

template <int kArm, int kForm>
int launch(const Params& p, int W, cudaStream_t stream) {
  const bool ca = kArm == kCostAware;
  if (W < 1 || W > kMaxWarps || p.R < 1 || p.H < 1 || p.T < 0 ||
      p.Z < 1 || p.G < 1 ||
      (ca && (p.cost_zz == nullptr || p.bw_zz == nullptr)) ||
      (!ca && (p.w_norm != nullptr || p.score_bw != nullptr)) ||
      (kArm == kOpportunistic &&
       (p.weyl_rot == nullptr || (p.T > 0 && p.u_p == nullptr))) ||
      (ca && kForm == kFormGlobal && p.snap_rows == nullptr) ||
      (kForm == kFormShared && p.Z > kMaxZones)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(
      smem_bytes(p.H, p.Z, kForm, kArm, p.risk != nullptr ? 1 : 0));
  auto kernel = ensemble_chain_kernel<kArm, kForm>;
  if (smem > 48 * 1024) {  // above the default limit only by opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<p.R, 32 * W, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kArm>
int dispatch_form(const Params& p, int form, int W, cudaStream_t s) {
  switch (form) {
    case kFormShared: return launch<kArm, kFormShared>(p, W, s);
    case kFormGlobal: return launch<kArm, kFormGlobal>(p, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of a launch shape.
size_t ensemble_chain_smem_bytes(int H, int Z, int form, int arm, int risk) {
  return static_cast<size_t>(smem_bytes(H, Z, form, arm, risk));
}

// Threads one CTA may run: its __launch_bounds__.
int ensemble_chain_max_threads() { return max_threads(); }

// One launch on `stream`: a tick's chain for R replicas, one CTA of
// 32·warps threads each; arm 0 cost-aware, 1 first-fit, 2 best-fit, 3
// opportunistic; form 0 (rows in shared memory) or 1 (rows in place in
// global memory).  Null for an operand the arm or option does not take.
// Returns cudaGetLastError() after the launch (0 on success), or the
// error that refused the shape.  Pointers come from torch tensors the
// caller has checked for device, type, shape, contiguity and 16-byte
// alignment.
int ensemble_chain_launch(float* avail, const int64_t* g_p,
                          const int64_t* az_p, const int64_t* bf_p,
                          const int64_t* order, const float* u_p,
                          const int64_t* n_ready, const float* dem_group,
                          const float* cd, const int64_t* host_zone,
                          const float* cost_zz, const float* bw_zz,
                          const float* risk, const float* w_norm,
                          const float* weyl_rot, const float* score_bw,
                          float* snap_rows, int64_t* pl, float* delay, int R,
                          int T, int H, int G, int Z, int table_rows, int arm,
                          int form, int warps, void* stream) {
  const Params p{reinterpret_cast<float4*>(avail),
                 g_p,
                 az_p,
                 bf_p,
                 order,
                 u_p,
                 n_ready,
                 reinterpret_cast<const float4*>(dem_group),
                 cd,
                 host_zone,
                 cost_zz,
                 bw_zz,
                 risk,
                 w_norm,
                 weyl_rot,
                 score_bw,
                 snap_rows,
                 pl,
                 delay,
                 R,
                 T,
                 H,
                 G,
                 Z,
                 table_rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kCostAware: return dispatch_form<kCostAware>(p, form, warps, s);
    case kFirstFit: return dispatch_form<kFirstFit>(p, form, warps, s);
    case kBestFit: return dispatch_form<kBestFit>(p, form, warps, s);
    case kOpportunistic:
      return dispatch_form<kOpportunistic>(p, form, warps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
