// The pose and point legs of the point-eliminated Schur matvec on grid
// tables: schur_point_leg_kernel<E> (pass A) and schur_pose_leg_kernel<E>
// (pass B).
//
// Replaces no Pallas kernel: in the reference package these legs are XLA
// einsums (camera_calibration_tpu/ba/lm_pcg.py, the grid paths of
// _jv_imageset, _jv_point, _jtw_imageset and _jtw_point under
// schur_pcg_solve).  In plain PyTorch they were four grid einsums (three of
// which copy the whole (M, P, 2, k) Jacobian before their batched product),
// the camera einsums, fresh zero tangents and about 55 launches per matvec.
//
// What they compute, for one camera's table in grid layout (row n = m·P + p
// for imageset m and point p; j_rig and j_cam (n, 2, 6), j_point (n, 2, 3),
// w (n,), the intrinsics part s_intr = J_intr·x_intr (n, 2)):
//   pass A:  s[n]   = J_rig[n]·x_rig[m] + J_cam[n]·x_cam + s_intr[n]
//            t[p]   = t_in[p] + sum_m J_point[n]^T · w[n] · s[n]
//   pass B:  y[p]   = D^-1[p] · t[p]       (d_inv: the damped 3x3 inverses)
//            ws[n]  = w[n] · (s[n] − J_point[n]·y[p])
//            rig[m] = rig_in[m] + sum_p J_rig[n]^T · ws[n]
//            cam    = sum_n J_cam[n]^T · ws[n]
// Pass B with no x (the reduced right-hand side) takes s = 0.  The element
// type E of the three Jacobians is float32 or bfloat16 (the CG matvecs'
// copies), widened on load; every other array is float32 and every sum is
// float32.
//
// What bounds them on an H100: memory bandwidth.  Each pass reads 132 B of
// a float32 slot (the three Jacobians, the weight, s_intr) for about 60
// FLOP; pass B writes ws (8 B).  At the 1080p cells' 1.04-1.73 M slots that
// is 0.09-0.14 ms a matvec at 3.35 TB/s, less where rows are unobserved.
//
// The design.  A row of weight 0 has zeroed Jacobians and s_intr, so it
// adds exactly 0 to every sum: its Jacobians are not read and its ws is
// written as 0.  One thread takes one slot at a time; its 48-byte Jacobian
// rows are read as three 16-byte loads through L1, so the sectors of a
// warp's 32 consecutive slots are fetched from L2 once.
// - Pass A sums over m, the strided axis.  A block takes a tile of
//   kPointThreads consecutive points (one a thread, so every load of a warp
//   is contiguous) and a chunk of rows m; the chunks are as many as fill
//   the card at once.  Each block writes its tile's partial sums; the last
//   block of a tile to finish (a ticket counter) adds the chunks' partial
//   sums in chunk order.  So the result repeats bit for bit, with no
//   atomics on the sums and no second launch.
// - Pass B sums over p, the contiguous axis, for rig, and over all slots
//   for cam.  A block takes one row m and walks its points; it reads t and
//   d_inv of each point (48 B a point, kept in L1/L2) and forms y there,
//   so no launch computes y apart.  On tables sharded over ranks each rank
//   runs both passes on its band of whole imagesets (a grid of its own),
//   and t is all-reduced between them.
//   The block's sums meet in a fixed shuffle tree; the last block adds the
//   rows' camera sums in row order.
// The ticket counters are the caller's (zeros); each launch leaves them 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kPointThreads = 128;
constexpr int kPoseThreads = 256;
constexpr int kPoseWarps = kPoseThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lo_bf16(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

// The 12 values of slot n of an (n, 2, 6) block.
__device__ __forceinline__ void load12(const float* a, size_t n,
                                       float (&v)[12]) {
  const float4* q = reinterpret_cast<const float4*>(a + 12 * n);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 f = __ldg(q + i);
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load12(const __nv_bfloat16* a, size_t n,
                                       float (&v)[12]) {
  const uint2* q = reinterpret_cast<const uint2*>(a + 12 * n);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint2 u = __ldg(q + i);
    v[4 * i] = lo_bf16(u.x);
    v[4 * i + 1] = hi_bf16(u.x);
    v[4 * i + 2] = lo_bf16(u.y);
    v[4 * i + 3] = hi_bf16(u.y);
  }
}

// The 6 values of slot n of an (n, 2, 3) block.
__device__ __forceinline__ void load6(const float* a, size_t n,
                                      float (&v)[6]) {
  const float2* q = reinterpret_cast<const float2*>(a + 6 * n);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float2 f = __ldg(q + i);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load6(const __nv_bfloat16* a, size_t n,
                                      float (&v)[6]) {
  const unsigned* q = reinterpret_cast<const unsigned*>(a + 6 * n);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const unsigned u = __ldg(q + i);
    v[2 * i] = lo_bf16(u);
    v[2 * i + 1] = hi_bf16(u);
  }
}

// s = J_rig·xr + J_cam·xc + s_intr of one slot (s_intr may be null: 0).
__device__ __forceinline__ void slot_s(const float (&jr)[12],
                                       const float (&jc)[12],
                                       const float (&xr)[6],
                                       const float (&xc)[6],
                                       const float* s_intr, size_t n,
                                       float (&s)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) a = fmaf(jr[6 * i + k], xr[k], a);
#pragma unroll
    for (int k = 0; k < 6; ++k) a = fmaf(jc[6 * i + k], xc[k], a);
    s[i] = a;
  }
  if (s_intr != nullptr) {
    const float2 si = __ldg(reinterpret_cast<const float2*>(s_intr) + n);
    s[0] += si.x;
    s[1] += si.y;
  }
}

// Whether this block is the last of `count` to arrive at `ticket`; every
// thread's global writes before the call are visible to the last block
// after it.  The last block sets the ticket back to 0.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket,
                                               unsigned count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned before = atomicAdd(ticket, 1u);
    last = before == count - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <class E>
__global__ void __launch_bounds__(kPointThreads)
schur_point_leg_kernel(const E* __restrict__ jrig, const E* __restrict__ jcam,
                       const E* __restrict__ jpt, const float* __restrict__ w,
                       const float* __restrict__ s_intr,
                       const float* __restrict__ x_rig,
                       const float* __restrict__ x_cam, int m_n, int p_n,
                       int rows, const float* __restrict__ t_in,
                       float* __restrict__ partial, unsigned* tickets,
                       float* __restrict__ t_out) {
  const int p = blockIdx.x * kPointThreads + threadIdx.x;
  const int m0 = blockIdx.y * rows;
  const int m1 = min(m_n, m0 + rows);
  const size_t P = static_cast<size_t>(p_n);
  float xc[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) xc[k] = __ldg(x_cam + k);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (p < p_n) {
#pragma unroll 2
    for (int m = m0; m < m1; ++m) {
      const size_t n = m * P + p;
      const float wn = __ldg(w + n);
      if (wn == 0.0f) continue;
      float jr[12], jc[12], jp[6], xr[6], s[2];
      load12(jrig, n, jr);
      load12(jcam, n, jc);
      load6(jpt, n, jp);
#pragma unroll
      for (int k = 0; k < 6; ++k) xr[k] = __ldg(x_rig + 6 * m + k);
      slot_s(jr, jc, xr, xc, s_intr, n, s);
      const float ws0 = wn * s[0], ws1 = wn * s[1];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        acc[k] = fmaf(jp[3 + k], ws1, fmaf(jp[k], ws0, acc[k]));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      partial[(static_cast<size_t>(blockIdx.y) * 3 + k) * P + p] = acc[k];
  }
  if (!last_to_arrive(tickets + blockIdx.x, gridDim.y)) return;
  if (p >= p_n) return;
  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < static_cast<int>(gridDim.y); ++c)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      sum[k] += __ldcg(partial + (static_cast<size_t>(c) * 3 + k) * P + p);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    t_out[3 * p + k] = (t_in != nullptr ? t_in[3 * p + k] : 0.0f) + sum[k];
}

template <class E>
__global__ void __launch_bounds__(kPoseThreads)
schur_pose_leg_kernel(const E* __restrict__ jrig, const E* __restrict__ jcam,
                      const E* __restrict__ jpt, const float* __restrict__ w,
                      const float* __restrict__ s_intr,
                      const float* __restrict__ x_rig,
                      const float* __restrict__ x_cam,
                      const float* __restrict__ t,
                      const float* __restrict__ d_inv, int m_n, int p_n,
                      float* __restrict__ ws_out, float* rig_out,
                      int accumulate, float* __restrict__ cam_partial,
                      unsigned* tickets, float* __restrict__ cam_out) {
  __shared__ float red[kPoseWarps][12];
  const int m = blockIdx.x;
  const size_t P = static_cast<size_t>(p_n);
  float xr[6], xc[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    xr[k] = x_rig != nullptr ? __ldg(x_rig + 6 * m + k) : 0.0f;
    xc[k] = x_cam != nullptr ? __ldg(x_cam + k) : 0.0f;
  }
  // rig sums in acc[0..5], camera sums in acc[6..11]
  float acc[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) acc[k] = 0.0f;
  for (int p = threadIdx.x; p < p_n; p += kPoseThreads) {
    const size_t n = m * P + p;
    const float wn = __ldg(w + n);
    float2 ws = make_float2(0.0f, 0.0f);
    if (wn != 0.0f) {
      float jr[12], jc[12], jp[6], s[2];
      load12(jrig, n, jr);
      load12(jcam, n, jc);
      load6(jpt, n, jp);
      float tp[3], y[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) tp[k] = __ldg(t + 3 * p + k);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float* d = d_inv + 9 * p + 3 * i;
        y[i] = fmaf(__ldg(d + 2), tp[2],
                    fmaf(__ldg(d + 1), tp[1], __ldg(d) * tp[0]));
      }
      slot_s(jr, jc, xr, xc, s_intr, n, s);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        s[i] -= fmaf(jp[3 * i + 2], y[2],
                     fmaf(jp[3 * i + 1], y[1], jp[3 * i] * y[0]));
      ws = make_float2(wn * s[0], wn * s[1]);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        acc[k] = fmaf(jr[6 + k], ws.y, fmaf(jr[k], ws.x, acc[k]));
        acc[6 + k] = fmaf(jc[6 + k], ws.y, fmaf(jc[k], ws.x, acc[6 + k]));
      }
    }
    reinterpret_cast<float2*>(ws_out)[n] = ws;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_xor_sync(kFull, acc[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) red[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < 12) {
    float sum = 0.0f;
#pragma unroll
    for (int g = 0; g < kPoseWarps; ++g) sum += red[g][threadIdx.x];
    if (threadIdx.x < 6) {
      float* r = rig_out + 6 * m + threadIdx.x;
      *r = (accumulate ? *r : 0.0f) + sum;
    } else {
      cam_partial[6 * m + threadIdx.x - 6] = sum;
    }
  }
  if (!last_to_arrive(tickets, gridDim.x)) return;
  // one warp per camera component: rows lane, lane + 32, ... then a fixed
  // shuffle tree
  if (warp < 6) {
    float sum = 0.0f;
    for (int r = lane; r < m_n; r += 32)
      sum += __ldcg(cam_partial + 6 * r + warp);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) cam_out[warp] = sum;
  }
}

// Rows of m a block of pass A takes so that its blocks fill the card at
// once: as many chunks as the resident blocks allow, over the point tiles.
int point_rows(int m_n, int p_n, int blocks_per_sm, int sms) {
  const int tiles = (p_n + kPointThreads - 1) / kPointThreads;
  int chunks = (blocks_per_sm * sms + tiles - 1) / tiles;
  if (chunks > m_n) chunks = m_n;
  if (chunks < 1) chunks = 1;
  return (m_n + chunks - 1) / chunks;
}

template <class E>
int point_blocks_per_sm() {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, schur_point_leg_kernel<E>, kPointThreads, 0);
  return per_sm;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// The launch plan of cct_schur_point_leg for an (M, P) grid and a Jacobian
// element size (4 float32, 2 bfloat16): out[0] threads per block, out[1]
// point tiles (the grid's x and the tickets it takes), out[2] chunks of
// rows (the grid's y and the partial sums' rows), out[3] rows per chunk.
extern "C" int cct_schur_point_leg_plan(int m, int p, int elem_bytes,
                                        int* out) {
  if (m <= 0 || p <= 0 || (elem_bytes != 4 && elem_bytes != 2))
    return cudaErrorInvalidValue;
  const int per_sm = elem_bytes == 4 ? point_blocks_per_sm<float>()
                                     : point_blocks_per_sm<__nv_bfloat16>();
  const int rows = point_rows(m, p, per_sm, sm_count());
  out[0] = kPointThreads;
  out[1] = (p + kPointThreads - 1) / kPointThreads;
  out[2] = (m + rows - 1) / rows;
  out[3] = rows;
  return cudaGetLastError();
}

// Pass A.  jrig, jcam (M·P, 2, 6), jpt (M·P, 2, 3) of one element type;
// w (M·P,), s_intr (M·P, 2), x_rig (M, 6), x_cam (6,), t_in (P, 3) or
// null; partial (chunks·3·P) scratch; tickets (tiles) zeros; t_out (P, 3).
// rows and the launch grid follow cct_schur_point_leg_plan.
extern "C" int cct_schur_point_leg(const void* jrig, const void* jcam,
                                   const void* jpt, const float* w,
                                   const float* s_intr, const float* x_rig,
                                   const float* x_cam, int m, int p,
                                   int elem_bytes, int rows,
                                   const float* t_in, float* partial,
                                   unsigned* tickets, float* t_out,
                                   cudaStream_t stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const dim3 grid((p + kPointThreads - 1) / kPointThreads,
                  (m + rows - 1) / rows);
  if (elem_bytes == 4) {
    schur_point_leg_kernel<float><<<grid, kPointThreads, 0, stream>>>(
        static_cast<const float*>(jrig), static_cast<const float*>(jcam),
        static_cast<const float*>(jpt), w, s_intr, x_rig, x_cam, m, p, rows,
        t_in, partial, tickets, t_out);
  } else if (elem_bytes == 2) {
    schur_point_leg_kernel<__nv_bfloat16><<<grid, kPointThreads, 0,
                                            stream>>>(
        static_cast<const __nv_bfloat16*>(jrig),
        static_cast<const __nv_bfloat16*>(jcam),
        static_cast<const __nv_bfloat16*>(jpt), w, s_intr, x_rig, x_cam, m,
        p, rows, t_in, partial, tickets, t_out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Pass B.  Inputs as pass A's (s_intr, x_rig and x_cam all null for s =
// 0), t (P, 3), d_inv (P, 3, 3); ws_out (M·P, 2); rig_out (M, 6), added to
// where accumulate is 1; cam_partial (M·6) scratch; tickets (1) zero;
// cam_out (6).  One block of kPoseThreads per row m.
extern "C" int cct_schur_pose_leg(const void* jrig, const void* jcam,
                                  const void* jpt, const float* w,
                                  const float* s_intr, const float* x_rig,
                                  const float* x_cam, const float* t,
                                  const float* d_inv, int m, int p,
                                  int elem_bytes, float* ws_out,
                                  float* rig_out, int accumulate,
                                  float* cam_partial, unsigned* tickets,
                                  float* cam_out, cudaStream_t stream) {
  if (m <= 0 || p <= 0) return cudaErrorInvalidValue;
  if (elem_bytes == 4) {
    schur_pose_leg_kernel<float><<<m, kPoseThreads, 0, stream>>>(
        static_cast<const float*>(jrig), static_cast<const float*>(jcam),
        static_cast<const float*>(jpt), w, s_intr, x_rig, x_cam, t, d_inv, m,
        p, ws_out, rig_out, accumulate, cam_partial, tickets, cam_out);
  } else if (elem_bytes == 2) {
    schur_pose_leg_kernel<__nv_bfloat16><<<m, kPoseThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(jrig),
        static_cast<const __nv_bfloat16*>(jcam),
        static_cast<const __nv_bfloat16*>(jpt), w, s_intr, x_rig, x_cam, t,
        d_inv, m, p, ws_out, rig_out, accumulate, cam_partial, tickets,
        cam_out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
