// Felsenstein pruning over slot-reuse schedules (io/schedule.py), called
// from JAX through the XLA FFI (linearham_tpu/ops/pruning_kernel.py).
//
// One CUDA block per (tree, 64-site tile); one thread per (rate, site).
// A schedule entry applies one branch's message to a parent slot:
//
//   src   tip entries: xMSA row of the tip's codes; else the child's slot
//   penc  parent_slot * 4 + first * 2 + is_tip; -1 marks a padding entry
//   len   branch length
//
// Each thread owns its (rate, site) column of every live slot, so the walk
// over the schedule needs no barrier: the slot file sits in shared memory
// laid out [slot][thread] as float4 (the 4 states), conflict-free.  The
// per-entry [R, 4, 4] transition matrices
//
//   P = max(U diag(exp(lam * t * rate)) U^-1, 0)
//
// are built cooperatively, kChunk entries at a time, and read by every
// site of the block, as I + U diag(expm1(lam * t * rate)) U^-1: the
// identity is exact and the O(t) part keeps f32's relative precision,
// where summing the eigen terms of P directly cancels to an absolute
// error of ~1e-7 in every small off-diagonal entry (a relative error of
// ~1e-4 per substitution on short branches).  Partials are rescaled by the power of two of their
// maximum after every entry; the exponents are summed as integers and
// enter the log-likelihood once at the root, so rescaling adds no rounding.
// The only device-memory traffic is the schedule, the shared xMSA codes
// (read by tip entries) and the [T, X] site log-likelihoods written.
//
// Built twice from this one file: by nvcc for sm_90a (the GPU kernel, FFI
// target "lh_prune" on CUDA), and by g++ (the same per-thread arithmetic
// run serially on the CPU, FFI target "lh_prune" on the host platform) so
// the CPU test suite exercises the kernel's own code.

#include <cmath>
#include <cstdint>
#include <vector>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LH_HD __host__ __device__ __forceinline__
typedef float4 lh_f4;
#else
#define LH_HD inline
struct lh_f4 {
  float x, y, z, w;
};
#endif

namespace {

constexpr int kSites = 64;   // sites per block
constexpr int kChunk = 32;   // entries whose matrices a block builds at once
constexpr float kLn2 = 0.6931471805599453f;

// Per-tree constants: u [16], uinv [16], lam [4], pi [4], then rates [R].
constexpr int kU = 0, kUinv = 16, kLam = 32, kPi = 36, kRates = 40;

// P[i][j] for one entry and rate, from em1[m] = expm1(lam[m] * t * rate).
LH_HD float pmat_entry(const float* c, const float* em1, int i, int j) {
  float acc = 0.f;
  for (int m = 0; m < 4; ++m)
    acc += c[kU + i * 4 + m] * em1[m] * c[kUinv + m * 4 + j];
  return fmaxf((i == j ? 1.f : 0.f) + acc, 0.f);
}

LH_HD float comp(const lh_f4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

struct Walker {
  lh_f4 acc;      // copy of the slot written last ...
  int acc_slot;   // ... and its index (-1: none)
  int escale;     // summed power-of-two exponents of the rescalings
};

// Apply one schedule entry for one (rate, site).  `slots` holds this
// thread's column of the slot file with stride `stride`; `P` holds the
// entry's 4 matrix rows for this rate; `code` is the tip's xMSA code.
LH_HD void apply_entry(lh_f4* slots, int stride, Walker& w, const lh_f4* P,
                       int src, int penc, int code) {
  const int p = penc >> 2;
  lh_f4 msg;
  if (penc & 1) {
    if (code < 0 || code >= 4) {   // N: contributes exactly nothing
      msg = lh_f4{1.f, 1.f, 1.f, 1.f};
    } else {
      msg = lh_f4{comp(P[0], code), comp(P[1], code), comp(P[2], code),
                  comp(P[3], code)};
    }
  } else {
    const lh_f4 c = src == w.acc_slot ? w.acc : slots[src * stride];
    msg.x = P[0].x * c.x + P[0].y * c.y + P[0].z * c.z + P[0].w * c.w;
    msg.y = P[1].x * c.x + P[1].y * c.y + P[1].z * c.z + P[1].w * c.w;
    msg.z = P[2].x * c.x + P[2].y * c.y + P[2].z * c.z + P[2].w * c.w;
    msg.w = P[3].x * c.x + P[3].y * c.y + P[3].z * c.z + P[3].w * c.w;
  }
  lh_f4 upd = msg;
  if (!((penc >> 1) & 1)) {
    const lh_f4 q = p == w.acc_slot ? w.acc : slots[p * stride];
    upd.x *= q.x;
    upd.y *= q.y;
    upd.z *= q.z;
    upd.w *= q.w;
  }
  const float m = fmaxf(fmaxf(upd.x, upd.y), fmaxf(upd.z, upd.w));
  if (m > 0.f) {
    int e;
    frexpf(m, &e);
    const float s = ldexpf(1.f, -e);
    upd.x *= s;
    upd.y *= s;
    upd.z *= s;
    upd.w *= s;
    w.escale += e;
  }
  slots[p * stride] = upd;
  w.acc = upd;
  w.acc_slot = p;
}

// Per-rate root log-likelihood log(pi . partial) + log(rescaling).
LH_HD float root_loglik(const float* c, const lh_f4& r, int escale) {
  const float lik = c[kPi] * r.x + c[kPi + 1] * r.y + c[kPi + 2] * r.z +
                    c[kPi + 3] * r.w;
  return logf(lik) + static_cast<float>(escale) * kLn2;
}

// Mean over rate categories in log space; -inf when every rate is -inf.
LH_HD float mix_rates(const float* per_rate, int stride, int R) {
  float mx = -INFINITY;
  for (int r = 0; r < R; ++r) mx = fmaxf(mx, per_rate[r * stride]);
  if (mx == -INFINITY) return -INFINITY;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += expf(per_rate[r * stride] - mx);
  return mx + logf(s) - logf(static_cast<float>(R));
}

struct Dims {
  int64_t batch;   // product of the codes' leading (vmapped) dimensions
  int64_t trees;   // all trees; trees / batch of them share one codes table
  int64_t T, N, R, n_rows, X;
};

ffi::Error check_dims(const Dims& d, int64_t n_slots) {
  if (d.batch <= 0 || d.trees <= 0 || d.N <= 0 || d.X <= 0 || d.n_rows <= 0)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "empty input");
  if (d.trees % d.batch != 0)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "tree count is not a multiple of the codes batch");
  if (d.R < 1 || d.R > 16)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "rate categories must be 1..16");
  if (n_slots < 1)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "n_slots < 1");
  return ffi::Error::Success();
}

template <class C, class S, class F>
Dims dims_of(const C& codes, const S& src, const F& rates) {
  auto cd = codes.dimensions();
  auto sd = src.dimensions();
  Dims d;
  d.batch = 1;
  for (size_t i = 0; i + 2 < cd.size(); ++i) d.batch *= cd[i];
  d.n_rows = cd[cd.size() - 2];
  d.X = cd[cd.size() - 1];
  d.trees = 1;
  for (size_t i = 0; i + 1 < sd.size(); ++i) d.trees *= sd[i];
  d.T = d.batch > 0 ? d.trees / d.batch : 0;
  d.N = sd[sd.size() - 1];
  auto rd = rates.dimensions();
  d.R = rd[rd.size() - 1];
  return d;
}

#ifdef __CUDACC__

__global__ void prune_kernel(const int32_t* __restrict__ codes,
                             const int32_t* __restrict__ src,
                             const int32_t* __restrict__ penc,
                             const float* __restrict__ len,
                             const int32_t* __restrict__ root,
                             const float* __restrict__ u,
                             const float* __restrict__ uinv,
                             const float* __restrict__ lam,
                             const float* __restrict__ pi,
                             const float* __restrict__ rates,
                             float* __restrict__ out, int T, int N, int R,
                             int n_rows, int X, int n_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;   // R * kSites
  const int tid = threadIdx.x;
  const int r = tid / kSites;
  const int s = tid % kSites;
  const int64_t tree = blockIdx.x;   // batch * T + t
  const int x = blockIdx.y * kSites + s;
  const bool active = x < X;

  lh_f4* slots = reinterpret_cast<lh_f4*>(smem);             // n_slots * nthreads
  float* P = reinterpret_cast<float*>(slots + n_slots * nthreads);  // kChunk*R*16
  float* E = P + kChunk * R * 16;                             // kChunk*R*4
  float* c = E + kChunk * R * 4;                              // 40 + R
  int* ent = reinterpret_cast<int*>(c + kRates + R);          // 3 * kChunk

  for (int i = tid; i < kRates + R; i += nthreads) {
    float v;
    if (i < kUinv) v = u[tree * 16 + i];
    else if (i < kLam) v = uinv[tree * 16 + i - kUinv];
    else if (i < kPi) v = lam[tree * 4 + i - kLam];
    else if (i < kRates) v = pi[tree * 4 + i - kPi];
    else v = rates[tree * R + i - kRates];
    c[i] = v;
  }

  const int32_t* codes_b = codes + (tree / T) * static_cast<int64_t>(n_rows) * X;
  Walker w{lh_f4{0.f, 0.f, 0.f, 0.f}, -1, 0};
  lh_f4* mine = slots + tid;

  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int K = min(kChunk, N - c0);
    __syncthreads();   // the previous chunk's matrices are consumed
    for (int i = tid; i < K; i += nthreads) {
      ent[i] = src[tree * N + c0 + i];
      ent[kChunk + i] = penc[tree * N + c0 + i];
      reinterpret_cast<float*>(ent)[2 * kChunk + i] = len[tree * N + c0 + i];
    }
    __syncthreads();
    const float* lens = reinterpret_cast<const float*>(ent) + 2 * kChunk;
    for (int i = tid; i < K * R * 4; i += nthreads) {
      const int k = i / (R * 4), rr = (i / 4) % R, m = i % 4;
      E[i] = expm1f(c[kLam + m] * lens[k] * c[kRates + rr]);
    }
    __syncthreads();
    for (int i = tid; i < K * R * 16; i += nthreads) {
      const int kr = i / 16, ij = i % 16;
      P[i] = pmat_entry(c, E + kr * 4, ij / 4, ij % 4);
    }
    __syncthreads();
    if (active) {
      for (int k = 0; k < K; ++k) {
        const int pe = ent[kChunk + k];
        if (pe < 0) continue;
        const int sr = ent[k];
        const int code = (pe & 1) ? __ldg(codes_b + static_cast<int64_t>(sr) * X + x) : 0;
        const lh_f4* Pk = reinterpret_cast<const lh_f4*>(P + (k * R + r) * 16);
        const lh_f4 rows[4] = {Pk[0], Pk[1], Pk[2], Pk[3]};
        apply_entry(mine, nthreads, w, rows, sr, pe, code);
      }
    }
  }

  // E is free after the last chunk's barrier: reuse it for the rate mix.
  float* per_rate = E;
  if (active) {
    const int rs = root[tree];
    const lh_f4 rp = rs == w.acc_slot ? w.acc : mine[rs * nthreads];
    per_rate[r * kSites + s] = root_loglik(c, rp, w.escale);
  }
  __syncthreads();
  if (active && r == 0)
    out[tree * X + x] = mix_rates(per_rate + s, kSites, R);
}

size_t smem_bytes(int R, int n_slots) {
  const int nthreads = R * kSites;
  return static_cast<size_t>(n_slots) * nthreads * sizeof(lh_f4) +
         sizeof(float) * (kChunk * R * 16 + kChunk * R * 4 + kRates + R) +
         sizeof(int) * 3 * kChunk;
}

ffi::Error PruneCuda(cudaStream_t stream, ffi::Buffer<ffi::S32> codes,
                     ffi::Buffer<ffi::S32> src, ffi::Buffer<ffi::S32> penc,
                     ffi::Buffer<ffi::F32> len, ffi::Buffer<ffi::S32> root,
                     ffi::Buffer<ffi::F32> u, ffi::Buffer<ffi::F32> uinv,
                     ffi::Buffer<ffi::F32> lam, ffi::Buffer<ffi::F32> pi,
                     ffi::Buffer<ffi::F32> rates,
                     ffi::ResultBuffer<ffi::F32> out, int32_t n_slots) {
  const Dims d = dims_of(codes, src, rates);
  ffi::Error err = check_dims(d, n_slots);
  if (!err.success()) return err;
  const size_t smem = smem_bytes(static_cast<int>(d.R), n_slots);
  cudaError_t ce = cudaFuncSetAttribute(
      prune_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (ce != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(ce));
  const dim3 grid(static_cast<unsigned>(d.trees),
                  static_cast<unsigned>((d.X + kSites - 1) / kSites));
  prune_kernel<<<grid, static_cast<unsigned>(d.R * kSites), smem, stream>>>(
      codes.typed_data(), src.typed_data(), penc.typed_data(),
      len.typed_data(), root.typed_data(), u.typed_data(), uinv.typed_data(),
      lam.typed_data(), pi.typed_data(), rates.typed_data(),
      out->typed_data(), static_cast<int>(d.T), static_cast<int>(d.N),
      static_cast<int>(d.R), static_cast<int>(d.n_rows),
      static_cast<int>(d.X), n_slots);
  ce = cudaGetLastError();
  if (ce != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(ce));
  return ffi::Error::Success();
}

#else  // host build: the same arithmetic, one (rate, site) at a time

ffi::Error PruneHost(ffi::Buffer<ffi::S32> codes, ffi::Buffer<ffi::S32> src,
                     ffi::Buffer<ffi::S32> penc, ffi::Buffer<ffi::F32> len,
                     ffi::Buffer<ffi::S32> root, ffi::Buffer<ffi::F32> u,
                     ffi::Buffer<ffi::F32> uinv, ffi::Buffer<ffi::F32> lam,
                     ffi::Buffer<ffi::F32> pi, ffi::Buffer<ffi::F32> rates,
                     ffi::ResultBuffer<ffi::F32> out, int32_t n_slots) {
  const Dims d = dims_of(codes, src, rates);
  ffi::Error err = check_dims(d, n_slots);
  if (!err.success()) return err;
  const int R = static_cast<int>(d.R), N = static_cast<int>(d.N);
  const int64_t X = d.X;
  std::vector<float> c(kRates + R), P(static_cast<size_t>(N) * R * 16);
  std::vector<lh_f4> slots(n_slots);
  std::vector<float> per_rate(R);
  for (int64_t tree = 0; tree < d.trees; ++tree) {
    for (int i = 0; i < 16; ++i) {
      c[kU + i] = u.typed_data()[tree * 16 + i];
      c[kUinv + i] = uinv.typed_data()[tree * 16 + i];
    }
    for (int i = 0; i < 4; ++i) {
      c[kLam + i] = lam.typed_data()[tree * 4 + i];
      c[kPi + i] = pi.typed_data()[tree * 4 + i];
    }
    for (int i = 0; i < R; ++i) c[kRates + i] = rates.typed_data()[tree * R + i];
    const int32_t* s_t = src.typed_data() + tree * N;
    const int32_t* p_t = penc.typed_data() + tree * N;
    for (int k = 0; k < N; ++k) {
      for (int r = 0; r < R; ++r) {
        float e[4];
        for (int m = 0; m < 4; ++m)
          e[m] = expm1f(c[kLam + m] * len.typed_data()[tree * N + k] *
                        c[kRates + r]);
        for (int ij = 0; ij < 16; ++ij)
          P[(static_cast<size_t>(k) * R + r) * 16 + ij] =
              pmat_entry(c.data(), e, ij / 4, ij % 4);
      }
    }
    const int32_t* codes_b = codes.typed_data() + (tree / d.T) * d.n_rows * X;
    for (int64_t x = 0; x < X; ++x) {
      for (int r = 0; r < R; ++r) {
        Walker w{lh_f4{0.f, 0.f, 0.f, 0.f}, -1, 0};
        for (int k = 0; k < N; ++k) {
          if (p_t[k] < 0) continue;
          const int code = (p_t[k] & 1) ? codes_b[s_t[k] * X + x] : 0;
          const float* Pk = P.data() + (static_cast<size_t>(k) * R + r) * 16;
          const lh_f4 rows[4] = {{Pk[0], Pk[1], Pk[2], Pk[3]},
                                 {Pk[4], Pk[5], Pk[6], Pk[7]},
                                 {Pk[8], Pk[9], Pk[10], Pk[11]},
                                 {Pk[12], Pk[13], Pk[14], Pk[15]}};
          apply_entry(slots.data(), 1, w, rows, s_t[k], p_t[k], code);
        }
        const int rs = root.typed_data()[tree];
        per_rate[r] = root_loglik(c.data(), rs == w.acc_slot ? w.acc : slots[rs],
                                  w.escale);
      }
      out->typed_data()[tree * X + x] = mix_rates(per_rate.data(), 1, R);
    }
  }
  return ffi::Error::Success();
}

#endif

}  // namespace

#define LH_PRUNE_BINDING(...)                 \
  ffi::Ffi::Bind()                            \
      __VA_ARGS__                             \
      .Arg<ffi::Buffer<ffi::S32>>()  /* codes */ \
      .Arg<ffi::Buffer<ffi::S32>>()  /* src */   \
      .Arg<ffi::Buffer<ffi::S32>>()  /* penc */  \
      .Arg<ffi::Buffer<ffi::F32>>()  /* len */   \
      .Arg<ffi::Buffer<ffi::S32>>()  /* root */  \
      .Arg<ffi::Buffer<ffi::F32>>()  /* u */     \
      .Arg<ffi::Buffer<ffi::F32>>()  /* uinv */  \
      .Arg<ffi::Buffer<ffi::F32>>()  /* lam */   \
      .Arg<ffi::Buffer<ffi::F32>>()  /* pi */    \
      .Arg<ffi::Buffer<ffi::F32>>()  /* rates */ \
      .Ret<ffi::Buffer<ffi::F32>>()  /* out */   \
      .Attr<int32_t>("n_slots")

#ifdef __CUDACC__
XLA_FFI_DEFINE_HANDLER_SYMBOL(
    LhPrune, PruneCuda,
    LH_PRUNE_BINDING(.Ctx<ffi::PlatformStream<cudaStream_t>>()));
#else
XLA_FFI_DEFINE_HANDLER_SYMBOL(LhPrune, PruneHost, LH_PRUNE_BINDING());
#endif
