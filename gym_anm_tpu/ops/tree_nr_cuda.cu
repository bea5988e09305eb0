// Tree-structured Newton-Raphson power flow for radial networks on NVIDIA
// GPUs (sm_90a), called from JAX through the XLA FFI.
//
// One thread solves one environment lane.  The schedule is the host-built
// elimination order of ops/tree_nr.py (``build_tree_info``): node slots are
// numbered leaves first, so every child slot precedes its parent slot.  A
// lane then walks the slots in order:
//
//   eval      ascending:  V = vm e^{j theta}; I = Y V over the tree edges
//                         (children push Y[parent, child] V_child upward);
//                         mismatch F = V conj(I) - S and its inf-norm.
//   eliminate ascending:  2x2 polar Jacobian blocks built on the fly, the
//                         effective diagonal inverted in closed form, and
//                         the Schur complement pushed to the parent.
//   back-sub  descending: dx = Dinv (b - U dx_parent); theta, |V| updated.
//
// until the lane's mismatch is <= x_tol, it diverges (NaN), or the
// iteration budget is spent: each lane stops on its own.  The math, order of
// blocks and stopping rule are those of ops/tree_nr.py ``solve_pfe_tree``;
// ops/tree_cuda.py ``tree_walk_reference`` is the same walk in NumPy.
//
// Per-lane state lives in device memory laid out [slot, lane] (lane
// fastest), so the 32 threads of a warp touch 32 consecutive words.  The
// kernel is generic: any radial network runs through it, with its schedule
// passed in as two small arrays.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> tree_nr_cuda.cu
// (ops/tree_cuda.py does this at first use).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// Columns of the per-slot admittance table (ops/tree_cuda.py YC_*).
constexpr int kYc = 8;
constexpr int kDiagRe = 0, kDiagIm = 1;  // Y[bus, bus]
constexpr int kUpRe = 2, kUpIm = 3;      // Y[bus, parent bus]
constexpr int kDownRe = 4, kDownIm = 5;  // Y[parent bus, bus]

// Per-lane scratch planes of [S, B] floats, in this order.
enum Plane { kTh, kVm, kIr, kIi, kFp, kFq, kA00, kA01, kA10, kA11, kB0, kB1, kNumPlanes };

struct Lane {
  const float* yc;   // [S, kYc]
  const int32_t* par;  // [S], -1 = parent is the slack bus
  const float* p;    // [S, B] lane-offset
  const float* q;
  float* vr;         // [S, B] lane-offset (also the voltage outputs)
  float* vi;
  float* w[kNumPlanes];
  int S;
  int64_t B;

  __device__ float& at(Plane k, int s) const { return w[k][s * B]; }
};

// NaN-propagating running maximum (jnp.max semantics).
__device__ __forceinline__ float nan_max(float acc, float x) {
  return (x > acc || x != x) ? x : acc;
}

// 2x2 polar Jacobian block for row-bus voltage (a, b) (solve_load_flow.py
// 123-164; ops/tree_nr.py ``blocks``): w = current term, u = Y vn term.
struct Block {
  float m00, m01, m10, m11;
};

__device__ __forceinline__ Block jac_block(float a, float b, float wre, float wim, float ure, float uim) {
  return Block{a * wim - b * wre, a * ure + b * uim, a * wre + b * wim, b * ure - a * uim};
}

// U = J[node, parent]: row voltage v, w = -Y_up v_par, u = Y_up vn_par.
__device__ __forceinline__ Block upper_block(const float* y, float xr, float xi, float pr, float pi) {
  const float pmag = sqrtf(pr * pr + pi * pi);
  const float pnr = pr / pmag, pni = pi / pmag;
  const float wre = y[kUpRe] * pr - y[kUpIm] * pi;
  const float wim = y[kUpRe] * pi + y[kUpIm] * pr;
  const float ure = y[kUpRe] * pnr - y[kUpIm] * pni;
  const float uim = y[kUpRe] * pni + y[kUpIm] * pnr;
  return jac_block(xr, xi, -wre, -wim, ure, uim);
}

// Voltages, currents and mismatch at the lane's current (theta, vm);
// returns the mismatch inf-norm.
__device__ float eval_point(const Lane& L) {
  for (int s = 0; s < L.S; ++s) {
    float sn, cs;
    sincosf(L.at(kTh, s), &sn, &cs);
    const float m = L.at(kVm, s);
    L.vr[s * L.B] = m * cs;
    L.vi[s * L.B] = m * sn;
    L.at(kIr, s) = 0.0f;
    L.at(kIi, s) = 0.0f;
  }
  float diff = 0.0f;
  for (int s = 0; s < L.S; ++s) {
    const float* y = L.yc + s * kYc;
    const int ps = L.par[s];
    const float xr = L.vr[s * L.B], xi = L.vi[s * L.B];
    const float pr = ps >= 0 ? L.vr[ps * L.B] : 1.0f;
    const float pi = ps >= 0 ? L.vi[ps * L.B] : 0.0f;
    // I = Y_ii v + Y_ip v_par + (children, already pushed).
    const float cr = (y[kDiagRe] * xr - y[kDiagIm] * xi) + (y[kUpRe] * pr - y[kUpIm] * pi) + L.at(kIr, s);
    const float ci = (y[kDiagRe] * xi + y[kDiagIm] * xr) + (y[kUpRe] * pi + y[kUpIm] * pr) + L.at(kIi, s);
    L.at(kIr, s) = cr;
    L.at(kIi, s) = ci;
    if (ps >= 0) {
      L.at(kIr, ps) += y[kDownRe] * xr - y[kDownIm] * xi;
      L.at(kIi, ps) += y[kDownRe] * xi + y[kDownIm] * xr;
    }
    const float fp = (xr * cr + xi * ci) - L.p[s * L.B];
    const float fq = (xi * cr - xr * ci) - L.q[s * L.B];
    L.at(kFp, s) = fp;
    L.at(kFq, s) = fq;
    diff = nan_max(diff, fabsf(fp));
    diff = nan_max(diff, fabsf(fq));
  }
  return diff;
}

// One Newton step: leaf-to-root block elimination, then root-to-leaf
// back-substitution that updates (theta, vm) in place.  The accumulators
// A*/B* must be zero on entry and are left zero on exit.
__device__ void newton_step(const Lane& L) {
  for (int s = 0; s < L.S; ++s) {
    const float* y = L.yc + s * kYc;
    const int ps = L.par[s];
    const float xr = L.vr[s * L.B], xi = L.vi[s * L.B];
    const float vmag = sqrtf(xr * xr + xi * xi);
    const float vnr = xr / vmag, vni = xi / vmag;
    const float cr = L.at(kIr, s), ci = L.at(kIi, s);

    // Diagonal: w = I - Y_ii v, u = Y_ii vn, plus vn conj(I) on dSm.
    const float yvr = y[kDiagRe] * xr - y[kDiagIm] * xi;
    const float yvi = y[kDiagRe] * xi + y[kDiagIm] * xr;
    const float ure = y[kDiagRe] * vnr - y[kDiagIm] * vni;
    const float uim = y[kDiagRe] * vni + y[kDiagIm] * vnr;
    Block D = jac_block(xr, xi, cr - yvr, ci - yvi, ure, uim);
    D.m01 += vnr * cr + vni * ci;
    D.m11 += vni * cr - vnr * ci;

    // Effective diagonal and right-hand side after the children's Schur
    // complements; closed-form 2x2 inverse.
    const float d00 = D.m00 - L.at(kA00, s), d01 = D.m01 - L.at(kA01, s);
    const float d10 = D.m10 - L.at(kA10, s), d11 = D.m11 - L.at(kA11, s);
    const float b0 = L.at(kFp, s) - L.at(kB0, s);
    const float b1 = L.at(kFq, s) - L.at(kB1, s);
    const float det = d00 * d11 - d01 * d10;
    const float i00 = d11 / det, i01 = -d01 / det, i10 = -d10 / det, i11 = d00 / det;
    L.at(kA00, s) = i00;
    L.at(kA01, s) = i01;
    L.at(kA10, s) = i10;
    L.at(kA11, s) = i11;
    L.at(kB0, s) = b0;
    L.at(kB1, s) = b1;

    if (ps >= 0) {
      const float pr = L.vr[ps * L.B], pi = L.vi[ps * L.B];
      // L = J[parent, node]: row voltage v_par, w = -Y_down v, u = Y_down vn.
      const float wre = y[kDownRe] * xr - y[kDownIm] * xi;
      const float wim = y[kDownRe] * xi + y[kDownIm] * xr;
      const float lre = y[kDownRe] * vnr - y[kDownIm] * vni;
      const float lim = y[kDownRe] * vni + y[kDownIm] * vnr;
      const Block Lb = jac_block(pr, pi, -wre, -wim, lre, lim);
      const Block U = upper_block(y, xr, xi, pr, pi);
      // M = L Dinv; push M U and M b to the parent.
      const float m00 = Lb.m00 * i00 + Lb.m01 * i10, m01 = Lb.m00 * i01 + Lb.m01 * i11;
      const float m10 = Lb.m10 * i00 + Lb.m11 * i10, m11 = Lb.m10 * i01 + Lb.m11 * i11;
      L.at(kA00, ps) += m00 * U.m00 + m01 * U.m10;
      L.at(kA01, ps) += m00 * U.m01 + m01 * U.m11;
      L.at(kA10, ps) += m10 * U.m00 + m11 * U.m10;
      L.at(kA11, ps) += m10 * U.m01 + m11 * U.m11;
      L.at(kB0, ps) += m00 * b0 + m01 * b1;
      L.at(kB1, ps) += m10 * b0 + m11 * b1;
    }
  }

  // Back-substitution, root first; dx is kept in the (consumed) F planes.
  for (int s = L.S - 1; s >= 0; --s) {
    const int ps = L.par[s];
    float r0 = L.at(kB0, s), r1 = L.at(kB1, s);
    if (ps >= 0) {
      const Block U = upper_block(L.yc + s * kYc, L.vr[s * L.B], L.vi[s * L.B], L.vr[ps * L.B], L.vi[ps * L.B]);
      const float xp0 = L.at(kFp, ps), xp1 = L.at(kFq, ps);
      r0 -= U.m00 * xp0 + U.m01 * xp1;
      r1 -= U.m10 * xp0 + U.m11 * xp1;
    }
    const float dx0 = L.at(kA00, s) * r0 + L.at(kA01, s) * r1;
    const float dx1 = L.at(kA10, s) * r0 + L.at(kA11, s) * r1;
    L.at(kFp, s) = dx0;
    L.at(kFq, s) = dx1;
    L.at(kTh, s) -= dx0;
    L.at(kVm, s) -= dx1;
    L.at(kA00, s) = 0.0f;
    L.at(kA01, s) = 0.0f;
    L.at(kA10, s) = 0.0f;
    L.at(kA11, s) = 0.0f;
    L.at(kB0, s) = 0.0f;
    L.at(kB1, s) = 0.0f;
  }
}

__device__ void set_point(const Lane& L, const float* th, const float* vm) {
  for (int s = 0; s < L.S; ++s) {
    L.at(kTh, s) = th ? th[s * L.B] : 0.0f;
    L.at(kVm, s) = vm ? vm[s * L.B] : 1.0f;
  }
}

__global__ void tree_nr_kernel(const float* __restrict__ yc, const int32_t* __restrict__ par,
                               const float* __restrict__ p, const float* __restrict__ q,
                               const float* __restrict__ th_w, const float* __restrict__ vm_w,
                               float* __restrict__ vr, float* __restrict__ vi, float* __restrict__ diff_out,
                               int32_t* __restrict__ it_out, float* __restrict__ scratch, int S, int64_t B,
                               float x_tol, int max_iter, int warm) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= B) return;  // tail of the last block
  const int64_t plane = static_cast<int64_t>(S) * B;

  Lane L;
  L.yc = yc;
  L.par = par;
  L.p = p + lane;
  L.q = q + lane;
  L.vr = vr + lane;
  L.vi = vi + lane;
  for (int k = 0; k < kNumPlanes; ++k) L.w[k] = scratch + k * plane + lane;
  L.S = S;
  L.B = B;

  for (int s = 0; s < S; ++s) {
    for (int k = kA00; k <= kB1; ++k) L.at(static_cast<Plane>(k), s) = 0.0f;
  }

  // Flat start; with a warm point, keep whichever has the smaller finite
  // mismatch (ops/power_flow.py ``solve_pfe`` init guard).
  set_point(L, nullptr, nullptr);
  float diff = eval_point(L);
  if (warm) {
    set_point(L, th_w + lane, vm_w + lane);
    const float diff_w = eval_point(L);
    if (fabsf(diff_w) <= FLT_MAX && diff_w < diff) {  // finite and better
      diff = diff_w;
    } else {
      set_point(L, nullptr, nullptr);
      diff = eval_point(L);
    }
  }

  int it = 0;
  while (it < max_iter && diff > x_tol) {  // NaN stops the lane
    newton_step(L);
    ++it;
    diff = eval_point(L);
  }
  diff_out[lane] = diff;
  it_out[lane] = it;
}

}  // namespace

// Operands: ycols [S, 8] f32, par [S] s32, p/q [S, B] f32, th_w/vm_w
// [S, B] f32 (read only when ``warm``).  Results: vr/vi [S, B] f32, diff
// [B] f32, iterations [B] s32, scratch [12, S, B] f32.
ffi::Error TreeNrImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> ycols, ffi::Buffer<ffi::S32> par,
                      ffi::Buffer<ffi::F32> p, ffi::Buffer<ffi::F32> q, ffi::Buffer<ffi::F32> th_w,
                      ffi::Buffer<ffi::F32> vm_w, ffi::ResultBuffer<ffi::F32> vr, ffi::ResultBuffer<ffi::F32> vi,
                      ffi::ResultBuffer<ffi::F32> diff, ffi::ResultBuffer<ffi::S32> iters,
                      ffi::ResultBuffer<ffi::F32> scratch, float x_tol, int32_t max_iter, int32_t warm) {
  const auto dims = p.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("tree_nr: p must be [S, B]");
  const int64_t S = dims[0];
  const int64_t B = dims[1];
  const auto ydims = ycols.dimensions();
  if (ydims.size() != 2 || ydims[0] != S || ydims[1] != kYc || par.element_count() != static_cast<size_t>(S)) {
    return ffi::Error::InvalidArgument("tree_nr: ycols must be [S, 8] and par [S]");
  }
  if (warm && (th_w.element_count() != p.element_count() || vm_w.element_count() != p.element_count())) {
    return ffi::Error::InvalidArgument("tree_nr: warm start arrays must match p");
  }
  if (B == 0 || S == 0) return ffi::Error::Success();

  // Small batches spread over more SMs with one-warp blocks; large ones
  // fill the SMs either way.
  const int threads = B <= 131072 ? 32 : 128;
  const dim3 grid(static_cast<unsigned>((B + threads - 1) / threads));
  tree_nr_kernel<<<grid, threads, 0, stream>>>(
      ycols.typed_data(), par.typed_data(), p.typed_data(), q.typed_data(), th_w.typed_data(),
      vm_w.typed_data(), vr->typed_data(), vi->typed_data(), diff->typed_data(), iters->typed_data(),
      scratch->typed_data(), static_cast<int>(S), B, x_tol, max_iter, warm);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("tree_nr launch failed: ") + cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(GymAnmTreeNr, TreeNrImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ycols
                                  .Arg<ffi::Buffer<ffi::S32>>()  // par
                                  .Arg<ffi::Buffer<ffi::F32>>()  // p
                                  .Arg<ffi::Buffer<ffi::F32>>()  // q
                                  .Arg<ffi::Buffer<ffi::F32>>()  // th_w
                                  .Arg<ffi::Buffer<ffi::F32>>()  // vm_w
                                  .Ret<ffi::Buffer<ffi::F32>>()  // vr
                                  .Ret<ffi::Buffer<ffi::F32>>()  // vi
                                  .Ret<ffi::Buffer<ffi::F32>>()  // diff
                                  .Ret<ffi::Buffer<ffi::S32>>()  // iterations
                                  .Ret<ffi::Buffer<ffi::F32>>()  // scratch
                                  .Attr<float>("x_tol")
                                  .Attr<int32_t>("max_iter")
                                  .Attr<int32_t>("warm"));
