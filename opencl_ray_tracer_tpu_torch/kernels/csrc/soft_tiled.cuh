// The per-pixel math of the soft renderer: one copy, shared by the tiled
// forward and backward kernels in soft_tiled.cu and the brute forward and
// backward kernels in soft_brute.cu (whose own pieces are at the end), so
// no two of them can drift. Every function here works on ONE pixel: the candidate
// tests, the rank, the streaming softmin, the aggregate geometry, the soft
// shadow occluder tests and the shading, each forward beside its
// hand-written reverse. The formulas and their evaluation order are those
// of kernels/soft_tiled.py's plain twin (and of the JAX package's
// kernels/soft_tiled.py tile math, lines 582-1206).
//
// Derivative conventions, held to the twin's autograd:
//   sigmoid' = s (1 - s), with sigmoid = 1/(1 + expf(-x)) so that a null
//   row's sigmoid(-1e9) is exactly 0 and its derivative too;
//   d log1p(-c) = -1 / (1 - c);
//   max/min/clip pass half the gradient to each side at an exact tie (the
//   rule of JAX's and torch's maximum/minimum), zero where not selected;
//   the det_ok and cov > 1e-12 selects give exactly zero gradient to the
//   branch not taken.
// The pixel-affine evaluations (u, v, t, tca, d^2) use fmaf, as the twin's
// _fma does: they cancel heavily and are rounded once per step. Reciprocal
// square roots are 1/sqrtf in both (the twin's 1/torch.sqrt).
//
// Without __CUDACC__ the functions compile as plain inline C++.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define OCTRT_FN __device__ __forceinline__
#define OCTRT_LDG(p) __ldg(p)
#else
#define OCTRT_FN inline
#define OCTRT_LDG(p) (*(p))
#endif

namespace octrt_soft {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int CH = 8;          // candidates are processed in whole groups of CH
constexpr int MAX_L = 4;       // lights
constexpr int MAX_P = 21 + 7 * MAX_L;
constexpr int ROW = 16;        // floats per coefficient row
constexpr int ALB = 8;         // floats per albedo row
constexpr float NEG_BIG = -1e30f;
constexpr float EPS = 1e-6f;
constexpr float SHADOW_OFFSET = 1e-2f;
constexpr float SHADOW_T_MIN = 1e-3f;
constexpr float UNOCC_HI = (float)(1.0 - 1e-6);
constexpr float FOG_K = (float)(255.0 / 180.0);

// params layout (kernels/fwd.py _P_*)
constexpr int P_O0 = 0, P_DOX = 3, P_DOY = 6, P_D0 = 9, P_DDX = 12, P_DDY = 15;
constexpr int P_AMB = 18, P_SPEC = 19, P_SHINE = 20, P_LIGHTS = 21, LSTRIDE = 7;

enum { SHADE_LEGACY = 0, SHADE_LAMBERT = 1, SHADE_PHONG = 2 };

// ---- scalar helpers ----------------------------------------------------
OCTRT_FN float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }
OCTRT_FN float dsig(float s) { return s * (1.0f - s); }
OCTRT_FN float softplus(float x) {  // logaddexp(x, 0)
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}
OCTRT_FN float gmax(float x, float c) {  // d max(x, c) / dx
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
OCTRT_FN float gmin(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
OCTRT_FN float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
OCTRT_FN float gclip(float x, float lo, float hi) {
  return gmax(x, lo) * gmin(fmaxf(x, lo), hi);
}
OCTRT_FN float aff(float c0, float c1, float c2, float x, float y) {
  return fmaf(y, c2, fmaf(x, c1, c0));
}
OCTRT_FN float log_unocc(float c) { return log1pf(-clipf(c, 0.0f, UNOCC_HI)); }
OCTRT_FN float g_log_unocc(float c) {  // d log1p(-clip(c)) / dc
  return -1.0f / (1.0f - clipf(c, 0.0f, UNOCC_HI)) * gclip(c, 0.0f, UNOCC_HI);
}

// ---- per-pixel context ---------------------------------------------------
struct Ctx {
  float x, y, x2, y2, xy;
  float o[3], d[3], du[3];
  float len2, inv_len, len_d;       // pinhole
  float tau_e, inv_td, inv_te, inv_te6, bt, tau_g, shift;
  float amb, spec, shine;
  int nl;
  float lp[MAX_L][3], lc[MAX_L][3], lint[MAX_L];
};

// Gradients w.r.t. the context entries that depend on params / taus.
struct CtxGrad {
  float o[3], d[3], inv_len, len_d;
  float inv_td, inv_te, inv_te6, bt, tau_g;
  float amb, spec, shine;
  float lp[MAX_L][3], lc[MAX_L][3], lint[MAX_L];
};

OCTRT_FN void zero_ctx_grad(CtxGrad& g) {
  float* p = reinterpret_cast<float*>(&g);
  for (int i = 0; i < (int)(sizeof(CtxGrad) / sizeof(float)); ++i) p[i] = 0.0f;
}

template <bool PROJ>
OCTRT_FN void ctx_make(Ctx& c, const float* prm, float tau_d, float tau_e,
                       float x, float y, int nl) {
  c.x = x;
  c.y = y;
  for (int q = 0; q < 3; ++q) {
    c.o[q] = OCTRT_LDG(prm + P_O0 + q) + x * OCTRT_LDG(prm + P_DOX + q) +
             y * OCTRT_LDG(prm + P_DOY + q);
  }
  if (PROJ) {
    for (int q = 0; q < 3; ++q) {
      c.du[q] = aff(OCTRT_LDG(prm + P_D0 + q), OCTRT_LDG(prm + P_DDX + q),
                    OCTRT_LDG(prm + P_DDY + q), x, y);
    }
    c.len2 = fmaxf(c.du[0] * c.du[0] + c.du[1] * c.du[1] + c.du[2] * c.du[2],
                   1e-20f);
    c.inv_len = 1.0f / sqrtf(c.len2);
    c.len_d = c.len2 * c.inv_len;
    for (int q = 0; q < 3; ++q) c.d[q] = c.du[q] * c.inv_len;
    c.x2 = c.y2 = c.xy = 0.0f;
  } else {
    for (int q = 0; q < 3; ++q) c.d[q] = OCTRT_LDG(prm + P_D0 + q);
    c.du[0] = c.du[1] = c.du[2] = 0.0f;
    c.len2 = c.inv_len = c.len_d = 0.0f;
    c.x2 = x * x;
    c.y2 = y * y;
    c.xy = x * y;
  }
  c.tau_e = tau_e;
  c.inv_td = 1.0f / tau_d;
  c.inv_te = 1.0f / tau_e;
  c.inv_te6 = 1.0f / fmaxf(tau_e, 1e-6f);
  c.bt = fmaxf(tau_e, 1e-3f);
  c.tau_g = fmaxf(tau_e, 1e-4f);
  c.shift = fmaxf(4.0f * c.tau_g, SHADOW_T_MIN);
  c.amb = OCTRT_LDG(prm + P_AMB);
  c.spec = OCTRT_LDG(prm + P_SPEC);
  c.shine = OCTRT_LDG(prm + P_SHINE);
  c.nl = nl;
  for (int l = 0; l < nl; ++l) {
    const float* b = prm + P_LIGHTS + l * LSTRIDE;
    for (int q = 0; q < 3; ++q) {
      c.lp[l][q] = OCTRT_LDG(b + q);
      c.lc[l][q] = OCTRT_LDG(b + 3 + q);
    }
    c.lint[l] = OCTRT_LDG(b + 6);
  }
}

// Context gradients -> params / taus gradients (added into dprm, dtau).
template <bool PROJ>
OCTRT_FN void ctx_bwd(const Ctx& c, const CtxGrad& g, float tau_d,
                      float* dprm, float* dtau) {
  for (int q = 0; q < 3; ++q) {
    dprm[P_O0 + q] += g.o[q];
    dprm[P_DOX + q] += c.x * g.o[q];
    dprm[P_DOY + q] += c.y * g.o[q];
  }
  if (PROJ) {
    // d = du * inv_len, len_d = len2 * inv_len, inv_len = len2^-1/2
    float g_inv = g.inv_len + g.len_d * c.len2;
    for (int q = 0; q < 3; ++q) g_inv += g.d[q] * c.du[q];
    const float il = c.inv_len;
    const float g_len2 = g.len_d * il + g_inv * (-0.5f * il * il * il);
    const float raw = c.du[0] * c.du[0] + c.du[1] * c.du[1] + c.du[2] * c.du[2];
    const float gl = g_len2 * gmax(raw, 1e-20f);
    for (int q = 0; q < 3; ++q) {
      const float gdu = g.d[q] * il + 2.0f * c.du[q] * gl;
      dprm[P_D0 + q] += gdu;
      dprm[P_DDX + q] += c.x * gdu;
      dprm[P_DDY + q] += c.y * gdu;
    }
  } else {
    for (int q = 0; q < 3; ++q) dprm[P_D0 + q] += g.d[q];
  }
  dprm[P_AMB] += g.amb;
  dprm[P_SPEC] += g.spec;
  dprm[P_SHINE] += g.shine;
  for (int l = 0; l < c.nl; ++l) {
    float* b = dprm + P_LIGHTS + l * LSTRIDE;
    for (int q = 0; q < 3; ++q) {
      b[q] += g.lp[l][q];
      b[3 + q] += g.lc[l][q];
    }
    b[6] += g.lint[l];
  }
  const float te = c.tau_e;
  dtau[0] += g.inv_td * (-c.inv_td * c.inv_td);
  (void)tau_d;
  dtau[1] += g.inv_te * (-c.inv_te * c.inv_te) +
             g.inv_te6 * (-c.inv_te6 * c.inv_te6) * gmax(te, 1e-6f) +
             g.bt * gmax(te, 1e-3f) + g.tau_g * gmax(te, 1e-4f);
}

// ---- primary candidate tests ------------------------------------------
// Triangles: ortho normals ride the albedo table (n = 0 here); pinhole
// normals are flipped per pixel against the ray.
template <bool PROJ>
OCTRT_FN void tri_fwd(const float* r, const Ctx& c, float& t, float& cov,
                      float n[3]) {
  if (PROJ) {
    const float det = aff(r[0], r[1], r[2], c.x, c.y);
    const float un = aff(r[3], r[4], r[5], c.x, c.y);
    const float vn = aff(r[6], r[7], r[8], c.x, c.y);
    const bool ok = fabsf(det) >= EPS * c.len_d;
    const float inv_det = 1.0f / (ok ? det : 1.0f);
    const float u = un * inv_det, v = vn * inv_det;
    t = r[9] * inv_det * c.len_d;
    cov = ok ? sigm(u * r[10]) * sigm(v * r[11]) * sigm((1.0f - u - v) * r[12])
             : 0.0f;
    const float nd = r[13] * c.d[0] + r[14] * c.d[1] + r[15] * c.d[2];
    const float fl = nd > 0.0f ? -1.0f : 1.0f;
    for (int q = 0; q < 3; ++q) n[q] = r[13 + q] * fl;
  } else {
    const float u = aff(r[0], r[1], r[2], c.x, c.y);
    const float v = aff(r[3], r[4], r[5], c.x, c.y);
    t = aff(r[6], r[7], r[8], c.x, c.y);
    cov = sigm(u * r[9]) * sigm(v * r[10]) * sigm((1.0f - u - v) * r[11]);
    n[0] = n[1] = n[2] = 0.0f;
  }
}

// cov = s1 * s2 * s3 of the barycentric sigmoids: their reverse into
// (gu, gv) and the three scale coefficients (gk[0..2]).
OCTRT_FN void bary_bwd(float u, float v, float k0, float k1, float k2,
                       float gcov, float& gu, float& gv, float gk[3]) {
  const float w = 1.0f - u - v;
  const float s1 = sigm(u * k0), s2 = sigm(v * k1), s3 = sigm(w * k2);
  const float z1 = gcov * s2 * s3 * dsig(s1);
  const float z2 = gcov * s1 * s3 * dsig(s2);
  const float z3 = gcov * s1 * s2 * dsig(s3);
  gk[0] = z1 * u;
  gk[1] = z2 * v;
  gk[2] = z3 * w;
  const float gw = z3 * k2;
  gu = z1 * k0 - gw;
  gv = z2 * k1 - gw;
}

template <bool PROJ>
OCTRT_FN void tri_bwd(const float* r, const Ctx& c, float gt, float gcov,
                      const float gn[3], float* gr, CtxGrad& gc) {
  float gk[3];
  if (PROJ) {
    const float det = aff(r[0], r[1], r[2], c.x, c.y);
    const float un = aff(r[3], r[4], r[5], c.x, c.y);
    const float vn = aff(r[6], r[7], r[8], c.x, c.y);
    const bool ok = fabsf(det) >= EPS * c.len_d;
    const float inv_det = 1.0f / (ok ? det : 1.0f);
    const float u = un * inv_det, v = vn * inv_det;
    const float nd = r[13] * c.d[0] + r[14] * c.d[1] + r[15] * c.d[2];
    const float fl = nd > 0.0f ? -1.0f : 1.0f;
    for (int q = 0; q < 3; ++q) gr[13 + q] += gn[q] * fl;
    float gu = 0.0f, gv = 0.0f;
    if (ok) {
      bary_bwd(u, v, r[10], r[11], r[12], gcov, gu, gv, gk);
      gr[10] += gk[0];
      gr[11] += gk[1];
      gr[12] += gk[2];
    }
    const float g_inv = gu * un + gv * vn + gt * r[9] * c.len_d;
    gr[9] += gt * inv_det * c.len_d;
    gc.len_d += gt * (r[9] * inv_det);
    const float gun = gu * inv_det, gvn = gv * inv_det;
    const float gdet = ok ? -g_inv * inv_det * inv_det : 0.0f;
    const float gs[3] = {gdet, gun, gvn};
    for (int k = 0; k < 3; ++k) {
      gr[3 * k] += gs[k];
      gr[3 * k + 1] += c.x * gs[k];
      gr[3 * k + 2] += c.y * gs[k];
    }
  } else {
    const float u = aff(r[0], r[1], r[2], c.x, c.y);
    const float v = aff(r[3], r[4], r[5], c.x, c.y);
    float gu, gv;
    bary_bwd(u, v, r[9], r[10], r[11], gcov, gu, gv, gk);
    gr[9] += gk[0];
    gr[10] += gk[1];
    gr[11] += gk[2];
    const float gs[3] = {gu, gv, gt};
    for (int k = 0; k < 3; ++k) {
      gr[3 * k] += gs[k];
      gr[3 * k + 1] += c.x * gs[k];
      gr[3 * k + 2] += c.y * gs[k];
    }
  }
}

// Soft sphere coverage and depth from (tca, d2): shared by the primary and
// the shadow sphere tests.
OCTRT_FN void sph_cov_t(float tca, float d2, float r2, float inv2r,
                        float twor, const Ctx& c, float& t, float& cov) {
  const float margin = (r2 - d2) * inv2r;
  cov = sigm(margin * c.inv_te) * sigm(tca * c.inv_te6);
  const float q = r2 - d2;
  const float beta = c.bt * twor;
  const float thc = sqrtf(beta * softplus(q / beta) + 1e-12f);
  t = tca - thc;
}

// reverse of sph_cov_t: adds into g_tca, g_d2, g_r2, g_inv2r, g_twor and
// the context's inv_te, inv_te6, bt.
OCTRT_FN void sph_cov_t_bwd(float tca, float d2, float r2, float inv2r,
                            float twor, const Ctx& c, float gt, float gcov,
                            float& g_tca, float& g_d2, float& g_r2,
                            float& g_inv2r, float& g_twor, CtxGrad& gc) {
  const float margin = (r2 - d2) * inv2r;
  const float s1 = sigm(margin * c.inv_te), s2 = sigm(tca * c.inv_te6);
  const float z1 = gcov * s2 * dsig(s1);
  const float z2 = gcov * s1 * dsig(s2);
  const float g_margin = z1 * c.inv_te;
  gc.inv_te += z1 * margin;
  g_tca += z2 * c.inv_te6;
  gc.inv_te6 += z2 * tca;
  g_r2 += g_margin * inv2r;
  g_d2 -= g_margin * inv2r;
  g_inv2r += g_margin * (r2 - d2);
  const float q = r2 - d2;
  const float beta = c.bt * twor;
  const float qb = q / beta;
  const float sp = softplus(qb);
  const float thc = sqrtf(beta * sp + 1e-12f);
  g_tca += gt;
  const float g_h = -gt * 0.5f / thc;
  const float g_qb = g_h * beta * sigm(qb);
  const float g_beta = g_h * sp - g_qb * q / (beta * beta);
  const float g_q = g_qb / beta;
  g_r2 += g_q;
  g_d2 -= g_q;
  g_twor += g_beta * c.bt;
  gc.bt += g_beta * twor;
}

template <bool PROJ>
OCTRT_FN void sph_fwd(const float* r, const Ctx& c, float& t, float& cov,
                      float n[3]) {
  float tca, d2, r2, inv2r, rinv, twor;
  const float* ctr;
  if (PROJ) {
    tca = aff(r[0], r[1], r[2], c.x, c.y) * c.inv_len;
    d2 = fmaf(-tca, tca, r[3]);
    r2 = r[4]; inv2r = r[5]; rinv = r[6]; ctr = r + 7; twor = r[10];
  } else {
    tca = aff(r[0], r[1], r[2], c.x, c.y);
    d2 = fmaf(c.xy, r[8], fmaf(c.y2, r[7], fmaf(c.x2, r[6],
                                                 aff(r[3], r[4], r[5], c.x, c.y))));
    r2 = r[9]; inv2r = r[10]; rinv = r[11]; ctr = r + 12; twor = r[15];
  }
  sph_cov_t(tca, d2, r2, inv2r, twor, c, t, cov);
  for (int q = 0; q < 3; ++q) n[q] = (c.o[q] + t * c.d[q] - ctr[q]) * rinv;
}

template <bool PROJ>
OCTRT_FN void sph_bwd(const float* r, const Ctx& c, float gt, float gcov,
                      const float gn[3], float* gr, CtxGrad& gc) {
  float tca, d2, r2, inv2r, rinv, twor, pre = 0.0f;
  int i_r2, i_ctr, i_twor;
  if (PROJ) {
    pre = aff(r[0], r[1], r[2], c.x, c.y);
    tca = pre * c.inv_len;
    d2 = fmaf(-tca, tca, r[3]);
    i_r2 = 4; i_ctr = 7; i_twor = 10;
  } else {
    tca = aff(r[0], r[1], r[2], c.x, c.y);
    d2 = fmaf(c.xy, r[8], fmaf(c.y2, r[7], fmaf(c.x2, r[6],
                                                 aff(r[3], r[4], r[5], c.x, c.y))));
    i_r2 = 9; i_ctr = 12; i_twor = 15;
  }
  r2 = r[i_r2]; inv2r = r[i_r2 + 1]; rinv = r[i_r2 + 2]; twor = r[i_twor];
  float t, cov;
  sph_cov_t(tca, d2, r2, inv2r, twor, c, t, cov);
  // n = (o + t d - ctr) * rinv
  float g_rinv = 0.0f;
  for (int q = 0; q < 3; ++q) {
    const float diff = c.o[q] + t * c.d[q] - r[i_ctr + q];
    g_rinv += gn[q] * diff;
    const float tmp = gn[q] * rinv;
    gc.o[q] += tmp;
    gt += tmp * c.d[q];
    gc.d[q] += tmp * t;
    gr[i_ctr + q] -= tmp;
  }
  float g_tca = 0.0f, g_d2 = 0.0f, g_r2 = 0.0f, g_inv2r = 0.0f, g_twor = 0.0f;
  sph_cov_t_bwd(tca, d2, r2, inv2r, twor, c, gt, gcov, g_tca, g_d2, g_r2,
                g_inv2r, g_twor, gc);
  gr[i_r2] += g_r2;
  gr[i_r2 + 1] += g_inv2r;
  gr[i_r2 + 2] += g_rinv;
  gr[i_twor] += g_twor;
  if (PROJ) {
    g_tca += g_d2 * (-2.0f * tca);
    gr[3] += g_d2;
    const float g_pre = g_tca * c.inv_len;
    gc.inv_len += g_tca * pre;
    gr[0] += g_pre;
    gr[1] += c.x * g_pre;
    gr[2] += c.y * g_pre;
  } else {
    gr[0] += g_tca;
    gr[1] += c.x * g_tca;
    gr[2] += c.y * g_tca;
    gr[3] += g_d2;
    gr[4] += c.x * g_d2;
    gr[5] += c.y * g_d2;
    gr[6] += c.x2 * g_d2;
    gr[7] += c.y2 * g_d2;
    gr[8] += c.xy * g_d2;
  }
}

OCTRT_FN float rank(float t, float cov, const Ctx& c) {
  return cov > 1e-12f ? -t * c.inv_td + logf(clipf(cov, 1e-12f, 1.0f))
                      : NEG_BIG;
}

// ---- shadow occluder tests (per-pixel shadow rays) ----------------------
OCTRT_FN void tri_sh_fwd(const float* r, const float so[3], const float sd[3],
                         float& t, float& cov) {
  const float *v0 = r, *e1 = r + 3, *e2 = r + 6;
  const float pv[3] = {sd[1] * e2[2] - sd[2] * e2[1],
                       sd[2] * e2[0] - sd[0] * e2[2],
                       sd[0] * e2[1] - sd[1] * e2[0]};
  const float det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2];
  const bool ok = fabsf(det) >= EPS;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const float tv[3] = {so[0] - v0[0], so[1] - v0[1], so[2] - v0[2]};
  const float u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv_det;
  const float qv[3] = {tv[1] * e1[2] - tv[2] * e1[1],
                       tv[2] * e1[0] - tv[0] * e1[2],
                       tv[0] * e1[1] - tv[1] * e1[0]};
  const float v = (sd[0] * qv[0] + sd[1] * qv[1] + sd[2] * qv[2]) * inv_det;
  t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv_det;
  cov = ok ? sigm(u * r[9]) * sigm(v * r[10]) * sigm((1.0f - u - v) * r[11])
           : 0.0f;
}

OCTRT_FN void cross_bwd(const float a[3], const float b[3], const float g[3],
                        float ga[3], float gb[3]) {
  // c = a x b: ga += b x g, gb += g x a
  ga[0] += b[1] * g[2] - b[2] * g[1];
  ga[1] += b[2] * g[0] - b[0] * g[2];
  ga[2] += b[0] * g[1] - b[1] * g[0];
  gb[0] += g[1] * a[2] - g[2] * a[1];
  gb[1] += g[2] * a[0] - g[0] * a[2];
  gb[2] += g[0] * a[1] - g[1] * a[0];
}

OCTRT_FN void tri_sh_bwd(const float* r, const float so[3], const float sd[3],
                         float gt, float gcov, float* gr, float g_so[3],
                         float g_sd[3]) {
  const float *v0 = r, *e1 = r + 3, *e2 = r + 6;
  const float pv[3] = {sd[1] * e2[2] - sd[2] * e2[1],
                       sd[2] * e2[0] - sd[0] * e2[2],
                       sd[0] * e2[1] - sd[1] * e2[0]};
  const float det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2];
  const bool ok = fabsf(det) >= EPS;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const float tv[3] = {so[0] - v0[0], so[1] - v0[1], so[2] - v0[2]};
  const float tvpv = tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2];
  const float qv[3] = {tv[1] * e1[2] - tv[2] * e1[1],
                       tv[2] * e1[0] - tv[0] * e1[2],
                       tv[0] * e1[1] - tv[1] * e1[0]};
  const float sdqv = sd[0] * qv[0] + sd[1] * qv[1] + sd[2] * qv[2];
  const float e2qv = e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2];
  const float u = tvpv * inv_det, v = sdqv * inv_det;
  float gu = 0.0f, gv = 0.0f, gk[3];
  if (ok) {
    bary_bwd(u, v, r[9], r[10], r[11], gcov, gu, gv, gk);
    gr[9] += gk[0];
    gr[10] += gk[1];
    gr[11] += gk[2];
  }
  const float g_inv = gu * tvpv + gv * sdqv + gt * e2qv;
  const float g_tvpv = gu * inv_det, g_sdqv = gv * inv_det;
  const float g_e2qv = gt * inv_det;
  float g_tv[3] = {0.f, 0.f, 0.f}, g_pv[3] = {0.f, 0.f, 0.f};
  float g_qv[3], g_e1[3] = {0.f, 0.f, 0.f}, g_e2[3];
  const float gdet = ok ? -g_inv * inv_det * inv_det : 0.0f;
  for (int q = 0; q < 3; ++q) {
    g_tv[q] += g_tvpv * pv[q];
    g_pv[q] += g_tvpv * tv[q] + gdet * e1[q];
    g_sd[q] += g_sdqv * qv[q];
    g_qv[q] = g_sdqv * sd[q] + g_e2qv * e2[q];
    g_e2[q] = g_e2qv * qv[q];
    g_e1[q] += gdet * pv[q];
  }
  cross_bwd(tv, e1, g_qv, g_tv, g_e1);  // qv = tv x e1
  cross_bwd(sd, e2, g_pv, g_sd, g_e2);  // pv = sd x e2
  for (int q = 0; q < 3; ++q) {
    g_so[q] += g_tv[q];
    gr[q] -= g_tv[q];
    gr[3 + q] += g_e1[q];
    gr[6 + q] += g_e2[q];
  }
}

OCTRT_FN void sph_sh_geom(const float* r, const float so[3], const float sd[3],
                          float l[3], float& tca, float& d2) {
  for (int q = 0; q < 3; ++q) l[q] = r[q] - so[q];
  tca = l[0] * sd[0] + l[1] * sd[1] + l[2] * sd[2];
  d2 = l[0] * l[0] + l[1] * l[1] + l[2] * l[2] - tca * tca;
}

OCTRT_FN void sph_sh_fwd(const float* r, const float so[3], const float sd[3],
                         const Ctx& c, float& t, float& cov) {
  float l[3], tca, d2;
  sph_sh_geom(r, so, sd, l, tca, d2);
  sph_cov_t(tca, d2, r[3], r[4], r[5], c, t, cov);
}

OCTRT_FN void sph_sh_bwd(const float* r, const float so[3], const float sd[3],
                         const Ctx& c, float gt, float gcov, float* gr,
                         float g_so[3], float g_sd[3], CtxGrad& gc) {
  float l[3], tca, d2;
  sph_sh_geom(r, so, sd, l, tca, d2);
  float g_tca = 0.0f, g_d2 = 0.0f;
  sph_cov_t_bwd(tca, d2, r[3], r[4], r[5], c, gt, gcov, g_tca, g_d2, gr[3],
                gr[4], gr[5], gc);
  g_tca += g_d2 * (-2.0f * tca);
  for (int q = 0; q < 3; ++q) {
    const float g_l = 2.0f * l[q] * g_d2 + g_tca * sd[q];
    g_sd[q] += g_tca * l[q];
    gr[q] += g_l;
    g_so[q] -= g_l;
  }
}

// One occluder's log(1 - occ) along a shadow ray, and its reverse.
template <bool SPHERE>
OCTRT_FN float occ_fwd(const float* r, const float so[3], const float sd[3],
                       float dist, const Ctx& c) {
  float t2, cov2;
  if (SPHERE) sph_sh_fwd(r, so, sd, c, t2, cov2);
  else tri_sh_fwd(r, so, sd, t2, cov2);
  const float occ = cov2 * sigm((t2 - c.shift) / c.tau_g) *
                    sigm((dist - t2) / c.tau_g);
  return log_unocc(occ);
}

template <bool SPHERE>
OCTRT_FN void occ_bwd(const float* r, const float so[3], const float sd[3],
                      float dist, const Ctx& c, float glv, float* gr,
                      float g_so[3], float g_sd[3], float& g_dist,
                      CtxGrad& gc) {
  float t2, cov2;
  if (SPHERE) sph_sh_fwd(r, so, sd, c, t2, cov2);
  else tri_sh_fwd(r, so, sd, t2, cov2);
  const float za = (t2 - c.shift) / c.tau_g, zb = (dist - t2) / c.tau_g;
  const float g1 = sigm(za), g2 = sigm(zb);
  const float occ = cov2 * g1 * g2;
  const float g_occ = glv * g_log_unocc(occ);
  const float g_cov2 = g_occ * g1 * g2;
  const float g_za = g_occ * cov2 * g2 * dsig(g1);
  const float g_zb = g_occ * cov2 * g1 * dsig(g2);
  const float g_t2 = (g_za - g_zb) / c.tau_g;
  g_dist += g_zb / c.tau_g;
  const float g_shift = -g_za / c.tau_g;
  gc.tau_g += -(g_za * za + g_zb * zb) / c.tau_g +
              g_shift * 4.0f * gmax(4.0f * c.tau_g, SHADOW_T_MIN);
  if (SPHERE) sph_sh_bwd(r, so, sd, c, g_t2, g_cov2, gr, g_so, g_sd, gc);
  else tri_sh_bwd(r, so, sd, g_t2, g_cov2, gr, g_so, g_sd);
}

// ---- streaming softmin state -------------------------------------------
struct Fin {
  float m, z, st, s[6], sn[3], bacc;  // aggregate: s = albedo(3) + tri normal(3)
};                                    // per-primitive: s[0..2] = colour sums

OCTRT_FN void fin_init(Fin& f) {
  f.m = NEG_BIG;
  f.z = f.st = f.bacc = 0.0f;
  for (int a = 0; a < 6; ++a) f.s[a] = 0.0f;
  f.sn[0] = f.sn[1] = f.sn[2] = 0.0f;
}

// Online max: returns the candidate's weight exp(logit - m_new) and the
// rescale exp(m_old - m_new) of the running sums.
OCTRT_FN float fin_step(Fin& f, float logit, float& scale) {
  if (logit > f.m) {
    scale = expf(f.m - logit);
    f.m = logit;
    return 1.0f;
  }
  scale = 1.0f;
  return expf(logit - f.m);
}

// Per-primitive shading contribution of one candidate with weight e:
// legacy fog, or lambert without shadows (x 255 applied at the end).
OCTRT_FN void nonagg_contrib(int shading, const Ctx& c, float t,
                             const float n[3], const float* alb, float e,
                             float cc[3]) {
  if (shading == SHADE_LEGACY) {
    const float sc = e * (255.0f - t * FOG_K);
    for (int a = 0; a < 3; ++a) cc[a] = alb[a] * sc;
    return;
  }
  float p[3], nn[3];
  for (int q = 0; q < 3; ++q) {
    p[q] = c.o[q] + t * c.d[q];
    nn[q] = n[q] + alb[3 + q];
  }
  for (int a = 0; a < 3; ++a) cc[a] = alb[a] * e * c.amb;
  for (int l = 0; l < c.nl; ++l) {
    float tl[3];
    for (int q = 0; q < 3; ++q) tl[q] = c.lp[l][q] - p[q];
    const float dist =
        sqrtf(fmaxf(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2], 1e-20f));
    const float ndotl =
        fmaxf((nn[0] * tl[0] + nn[1] * tl[1] + nn[2] * tl[2]) / dist, 0.0f);
    const float ew = e * (c.lint[l] * ndotl);
    for (int a = 0; a < 3; ++a) cc[a] += c.lc[l][a] * (alb[a] * ew);
  }
}

// Reverse of nonagg_contrib for cotangents gs (of the colour sums, x 255
// already applied for lambert): adds into g_e, g_t, g_n, g_alb, gc.
OCTRT_FN void nonagg_contrib_bwd(int shading, const Ctx& c, float t,
                                 const float n[3], const float* alb, float e,
                                 const float gs[3], float& g_e, float& g_t,
                                 float g_n[3], float* g_alb, CtxGrad& gc) {
  if (shading == SHADE_LEGACY) {
    const float sc = 255.0f - t * FOG_K;
    float g_esc = 0.0f;
    for (int a = 0; a < 3; ++a) {
      g_esc += gs[a] * alb[a];
      g_alb[a] += gs[a] * (e * sc);
    }
    g_e += g_esc * sc;
    g_t -= g_esc * e * FOG_K;
    return;
  }
  float p[3], nn[3], g_p[3] = {0.f, 0.f, 0.f}, g_nn[3] = {0.f, 0.f, 0.f};
  for (int q = 0; q < 3; ++q) {
    p[q] = c.o[q] + t * c.d[q];
    nn[q] = n[q] + alb[3 + q];
  }
  for (int a = 0; a < 3; ++a) {
    g_alb[a] += gs[a] * e * c.amb;
    g_e += gs[a] * alb[a] * c.amb;
    gc.amb += gs[a] * (alb[a] * e);
  }
  for (int l = 0; l < c.nl; ++l) {
    float tl[3];
    for (int q = 0; q < 3; ++q) tl[q] = c.lp[l][q] - p[q];
    const float tl2 = tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2];
    const float dist = sqrtf(fmaxf(tl2, 1e-20f));
    const float nd = nn[0] * tl[0] + nn[1] * tl[1] + nn[2] * tl[2];
    const float qq = nd / dist;
    const float ndotl = fmaxf(qq, 0.0f);
    const float w = c.lint[l] * ndotl;
    const float ew = e * w;
    float g_ew = 0.0f;
    for (int a = 0; a < 3; ++a) {
      gc.lc[l][a] += gs[a] * (alb[a] * ew);
      const float g_aew = gs[a] * c.lc[l][a];
      g_alb[a] += g_aew * ew;
      g_ew += g_aew * alb[a];
    }
    g_e += g_ew * w;
    const float g_w = g_ew * e;
    gc.lint[l] += g_w * ndotl;
    const float g_q = g_w * c.lint[l] * gmax(qq, 0.0f);
    const float g_nd = g_q / dist;
    const float g_dist = -g_q * qq / dist;
    const float g_tl2 = g_dist * 0.5f / dist * gmax(tl2, 1e-20f);
    for (int q = 0; q < 3; ++q) {
      g_nn[q] += g_nd * tl[q];
      const float g_tl = g_nd * nn[q] + 2.0f * tl[q] * g_tl2;
      gc.lp[l][q] += g_tl;
      g_p[q] -= g_tl;
    }
  }
  for (int q = 0; q < 3; ++q) {
    gc.o[q] += g_p[q];
    g_t += g_p[q] * c.d[q];
    gc.d[q] += g_p[q] * t;
    g_n[q] += g_nn[q];
    g_alb[3 + q] += g_nn[q];
  }
}

// ---- aggregate geometry + shading --------------------------------------
struct Geom {
  float zinv, w_bg, t_hat, nr[3], nn2, ninv, n[3], a[3], p[3], dd, vinv, v[3];
  float tl[MAX_L][3], tl2[MAX_L], dist[MAX_L], sd[MAX_L][3], so[MAX_L][3];
};

OCTRT_FN void geom_fwd(const Fin& f, const Ctx& c, Geom& G) {
  G.zinv = 1.0f / fmaxf(f.z, 1e-20f);
  G.w_bg = expf(f.bacc);
  G.t_hat = f.st * G.zinv;
  for (int q = 0; q < 3; ++q) G.nr[q] = (f.s[3 + q] + f.sn[q]) * G.zinv;
  G.nn2 = G.nr[0] * G.nr[0] + G.nr[1] * G.nr[1] + G.nr[2] * G.nr[2];
  G.ninv = 1.0f / sqrtf(fmaxf(G.nn2, 1e-20f));
  for (int q = 0; q < 3; ++q) {
    G.n[q] = G.nr[q] * G.ninv;
    G.a[q] = f.s[q] * G.zinv;
    G.p[q] = c.o[q] + G.t_hat * c.d[q];
  }
  G.dd = c.d[0] * c.d[0] + c.d[1] * c.d[1] + c.d[2] * c.d[2];
  G.vinv = 1.0f / sqrtf(fmaxf(G.dd, 1e-20f));
  for (int q = 0; q < 3; ++q) G.v[q] = -c.d[q] * G.vinv;
  for (int l = 0; l < c.nl; ++l) {
    for (int q = 0; q < 3; ++q) G.tl[l][q] = c.lp[l][q] - G.p[q];
    G.tl2[l] = G.tl[l][0] * G.tl[l][0] + G.tl[l][1] * G.tl[l][1] +
               G.tl[l][2] * G.tl[l][2];
    G.dist[l] = sqrtf(fmaxf(G.tl2[l], 1e-20f));
    for (int q = 0; q < 3; ++q) {
      G.sd[l][q] = G.tl[l][q] / G.dist[l];
      G.so[l][q] = G.p[q] + SHADOW_OFFSET * G.n[q];
    }
  }
}

// Cotangents of the streaming finals.
struct Cot {
  float z, st, s[6], sn[3], bacc;
};

OCTRT_FN void geom_bwd(const Fin& f, const Ctx& c, const Geom& G,
                       const float g_n_in[3], const float g_a[3],
                       const float g_v[3], float g_wbg,
                       const float g_sd[MAX_L][3], const float g_so[MAX_L][3],
                       const float g_dist[MAX_L], Cot& cot, CtxGrad& gc) {
  float g_p[3] = {0.f, 0.f, 0.f};
  float g_n[3] = {g_n_in[0], g_n_in[1], g_n_in[2]};
  for (int l = 0; l < c.nl; ++l) {
    const float dl = G.dist[l];
    float g_dt = g_dist[l];
    for (int q = 0; q < 3; ++q) {
      g_p[q] += g_so[l][q];
      g_n[q] += SHADOW_OFFSET * g_so[l][q];
      g_dt += g_sd[l][q] * (-G.tl[l][q] / (dl * dl));
    }
    const float g_tl2 = g_dt * 0.5f / dl * gmax(G.tl2[l], 1e-20f);
    for (int q = 0; q < 3; ++q) {
      const float g_tl = g_sd[l][q] / dl + 2.0f * G.tl[l][q] * g_tl2;
      gc.lp[l][q] += g_tl;
      g_p[q] -= g_tl;
    }
  }
  float g_vinv = 0.0f;
  for (int q = 0; q < 3; ++q) {
    g_vinv -= g_v[q] * c.d[q];
    gc.d[q] -= g_v[q] * G.vinv;
  }
  const float g_dd = g_vinv * (-0.5f * G.vinv * G.vinv * G.vinv) *
                     gmax(G.dd, 1e-20f);
  float g_that = 0.0f, g_zinv = 0.0f, g_ninv = 0.0f;
  for (int q = 0; q < 3; ++q) {
    gc.d[q] += 2.0f * c.d[q] * g_dd + g_p[q] * G.t_hat;
    gc.o[q] += g_p[q];
    g_that += g_p[q] * c.d[q];
    cot.s[q] = g_a[q] * G.zinv;
    g_zinv += g_a[q] * f.s[q];
    g_ninv += g_n[q] * G.nr[q];
  }
  const float g_nn2 = g_ninv * (-0.5f * G.ninv * G.ninv * G.ninv) *
                      gmax(G.nn2, 1e-20f);
  for (int q = 0; q < 3; ++q) {
    const float g_nr = g_n[q] * G.ninv + 2.0f * G.nr[q] * g_nn2;
    cot.s[3 + q] = g_nr * G.zinv;
    cot.sn[q] = g_nr * G.zinv;
    g_zinv += g_nr * (f.s[3 + q] + f.sn[q]);
  }
  cot.st = g_that * G.zinv;
  g_zinv += g_that * f.st;
  cot.bacc = g_wbg * G.w_bg;
  cot.z = g_zinv * (-G.zinv * G.zinv) * gmax(f.z, 1e-20f);
}

// Aggregate shading: geometry + per-light log-visibility -> rgb.
OCTRT_FN void shade_agg_fwd(const Geom& G, const Ctx& c, const float* logvis,
                            int shading, bool shadows, float out[3]) {
  float diff[3] = {0.f, 0.f, 0.f}, spec[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < c.nl; ++l) {
    const float* sd = G.sd[l];
    const float ndl = G.n[0] * sd[0] + G.n[1] * sd[1] + G.n[2] * sd[2];
    const float ndotl = fmaxf(ndl, 0.0f);
    const float vis = shadows ? expf(logvis[l]) : 1.0f;
    const float wd = c.lint[l] * ndotl * vis;
    for (int a = 0; a < 3; ++a) diff[a] += wd * c.lc[l][a];
    if (shading == SHADE_PHONG) {
      const float two = 2.0f * ndl;
      float rv = 0.0f;
      for (int q = 0; q < 3; ++q) rv += (two * G.n[q] - sd[q]) * G.v[q];
      const float rdotv = fmaxf(rv, 0.0f);
      const float ws = c.spec * expf(c.shine * logf(fmaxf(rdotv, 1e-20f))) *
                       c.lint[l] * vis * (ndotl > 0.0f ? 1.0f : 0.0f);
      for (int a = 0; a < 3; ++a) spec[a] += ws * c.lc[l][a];
    }
  }
  for (int a = 0; a < 3; ++a) {
    out[a] = clipf((1.0f - G.w_bg) * (G.a[a] * (c.amb + diff[a]) + spec[a]) *
                       255.0f,
                   0.0f, 255.0f);
  }
}

OCTRT_FN void shade_agg_bwd(const Geom& G, const Ctx& c, const float* logvis,
                            int shading, bool shadows, const float gout[3],
                            float g_n[3], float g_a[3], float g_v[3],
                            float& g_wbg, float g_sd[MAX_L][3],
                            float* g_logvis, CtxGrad& gc) {
  float diff[3] = {0.f, 0.f, 0.f}, spec[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < c.nl; ++l) {
    const float* sd = G.sd[l];
    const float ndl = G.n[0] * sd[0] + G.n[1] * sd[1] + G.n[2] * sd[2];
    const float ndotl = fmaxf(ndl, 0.0f);
    const float vis = shadows ? expf(logvis[l]) : 1.0f;
    const float wd = c.lint[l] * ndotl * vis;
    for (int a = 0; a < 3; ++a) diff[a] += wd * c.lc[l][a];
    if (shading == SHADE_PHONG) {
      const float two = 2.0f * ndl;
      float rv = 0.0f;
      for (int q = 0; q < 3; ++q) rv += (two * G.n[q] - sd[q]) * G.v[q];
      const float rdotv = fmaxf(rv, 0.0f);
      const float ws = c.spec * expf(c.shine * logf(fmaxf(rdotv, 1e-20f))) *
                       c.lint[l] * vis * (ndotl > 0.0f ? 1.0f : 0.0f);
      for (int a = 0; a < 3; ++a) spec[a] += ws * c.lc[l][a];
    }
  }
  float g_diff[3], g_spec[3];
  for (int a = 0; a < 3; ++a) {
    const float fg = G.a[a] * (c.amb + diff[a]) + spec[a];
    const float y = (1.0f - G.w_bg) * fg * 255.0f;
    const float gy = gout[a] * gclip(y, 0.0f, 255.0f);
    const float g_fg = gy * 255.0f * (1.0f - G.w_bg);
    g_wbg -= gy * 255.0f * fg;
    g_a[a] = g_fg * (c.amb + diff[a]);
    gc.amb += g_fg * G.a[a];
    g_diff[a] = g_fg * G.a[a];
    g_spec[a] = g_fg;
  }
  for (int q = 0; q < 3; ++q) g_n[q] = g_v[q] = 0.0f;
  for (int l = 0; l < c.nl; ++l) {
    const float* sd = G.sd[l];
    const float ndl = G.n[0] * sd[0] + G.n[1] * sd[1] + G.n[2] * sd[2];
    const float ndotl = fmaxf(ndl, 0.0f);
    const float vis = shadows ? expf(logvis[l]) : 1.0f;
    const float lint = c.lint[l];
    const float wd = lint * ndotl * vis;
    float g_wd = 0.0f;
    for (int a = 0; a < 3; ++a) {
      g_wd += g_diff[a] * c.lc[l][a];
      gc.lc[l][a] += g_diff[a] * wd;
    }
    gc.lint[l] += g_wd * ndotl * vis;
    const float g_ndotl = g_wd * lint * vis;
    float g_vis = g_wd * lint * ndotl;
    float g_ndl = 0.0f;
    for (int q = 0; q < 3; ++q) g_sd[l][q] = 0.0f;
    if (shading == SHADE_PHONG) {
      const float two = 2.0f * ndl;
      float r[3], rv = 0.0f;
      for (int q = 0; q < 3; ++q) {
        r[q] = two * G.n[q] - sd[q];
        rv += r[q] * G.v[q];
      }
      const float rdotv = fmaxf(rv, 0.0f);
      const float lg = logf(fmaxf(rdotv, 1e-20f));
      const float pw = expf(c.shine * lg);
      const float ind = ndotl > 0.0f ? 1.0f : 0.0f;
      const float ws = c.spec * pw * lint * vis * ind;
      float g_ws = 0.0f;
      for (int a = 0; a < 3; ++a) {
        g_ws += g_spec[a] * c.lc[l][a];
        gc.lc[l][a] += g_spec[a] * ws;
      }
      gc.spec += g_ws * ind * vis * lint * pw;
      const float g_pw = g_ws * ind * vis * lint * c.spec;
      gc.lint[l] += g_ws * ind * vis * c.spec * pw;
      g_vis += g_ws * ind * lint * c.spec * pw;
      gc.shine += g_pw * pw * lg;
      const float g_lg = g_pw * pw * c.shine;
      const float g_rdotv =
          g_lg / fmaxf(rdotv, 1e-20f) * gmax(rdotv, 1e-20f);
      const float g_rv = g_rdotv * gmax(rv, 0.0f);
      float g_two = 0.0f;
      for (int q = 0; q < 3; ++q) {
        const float g_r = g_rv * G.v[q];
        g_v[q] += g_rv * r[q];
        g_two += g_r * G.n[q];
        g_n[q] += g_r * two;
        g_sd[l][q] -= g_r;
      }
      g_ndl += 2.0f * g_two;
    }
    g_logvis[l] = shadows ? g_vis * vis : 0.0f;
    g_ndl += g_ndotl * gmax(ndl, 0.0f);
    for (int q = 0; q < 3; ++q) {
      g_n[q] += g_ndl * sd[q];
      g_sd[l][q] += g_ndl * G.n[q];
    }
  }
}

// N floats of a table row (N a multiple of 4, the row 16-byte aligned), as
// 128-bit loads on the card: every lane of a warp asks for the same row, so
// each load is one broadcast.
template <int N>
OCTRT_FN void ld_row(const float* p, float* r) {
#ifdef __CUDACC__
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * k);
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
#else
  for (int q = 0; q < N; ++q) r[q] = p[q];
#endif
}

template <int N>
OCTRT_FN bool nonzero(const float* v) {
  bool nz = false;
  for (int q = 0; q < N; ++q) nz |= v[q] != 0.0f;
  return nz;
}

// ---- one tile's tables, as a pixel sees them ------------------------------
struct Tabs {
  const float *tri, *tri_alb, *sph, *sph_alb;
  const float *tsh, *ssh;   // this tile's (or the shared) shadow tables
  int n_tri, n_sph;         // processed primary rows (whole groups of CH)
  int sh_tri_stride, sh_sph_stride;
  int n_tsh[MAX_L], n_ssh[MAX_L];
};

OCTRT_FN int processed(int cnt, int k) {
  const int n = (cnt + CH - 1) / CH * CH;
  return n < k ? n : k;
}

// One tested candidate (t, cov, explicit normal n, albedo row alb) into the
// streaming finals of one pixel.
OCTRT_FN void stream_accum(const Ctx& c, float t, float cov, const float n[3],
                           const float* alb, bool aggregate, int shading,
                           Fin& f) {
  float scale;
  const float e = fin_step(f, rank(t, cov, c), scale);
  f.z = f.z * scale + e;
  if (aggregate) {
    f.st = f.st * scale + e * t;
    for (int a = 0; a < 6; ++a) f.s[a] = f.s[a] * scale + alb[a] * e;
    for (int q = 0; q < 3; ++q) f.sn[q] = f.sn[q] * scale + e * n[q];
  } else {
    float cc[3];
    nonagg_contrib(shading, c, t, n, alb, e, cc);
    for (int a = 0; a < 3; ++a) f.s[a] = f.s[a] * scale + cc[a];
  }
  f.bacc += log_unocc(cov);
}

// One primary candidate row (r: ROW coefficients, alb: ALB albedo floats)
// into the streaming finals of one pixel; kind 0 = triangle, 1 = sphere.
template <bool PROJ>
OCTRT_FN void stream_row(const Ctx& c, const float* r, const float* alb,
                         int kind, bool aggregate, int shading, Fin& f) {
  float t, cov, n[3];
  if (kind) sph_fwd<PROJ>(r, c, t, cov, n);
  else tri_fwd<PROJ>(r, c, t, cov, n);
  stream_accum(c, t, cov, n, alb, aggregate, shading, f);
}

// Pass over the primary candidates, rows read straight from the tables:
// the streaming finals of one pixel (the backward's recompute).
template <bool PROJ>
OCTRT_FN void stream_finals(const Ctx& c, const Tabs& T, bool aggregate,
                            int shading, Fin& f) {
  fin_init(f);
  for (int kind = 0; kind < 2; ++kind) {
    const int nrow = kind ? T.n_sph : T.n_tri;
    const float* rows = kind ? T.sph : T.tri;
    const float* albs = kind ? T.sph_alb : T.tri_alb;
    for (int j = 0; j < nrow; ++j) {
      float r[ROW], alb[ALB];
      ld_row<ROW>(rows + j * ROW, r);
      ld_row<ALB>(albs + j * ALB, alb);
      stream_row<PROJ>(c, r, alb, kind, aggregate, shading, f);
    }
  }
}

OCTRT_FN float occ_logvis(const Ctx& c, const Tabs& T, int l,
                          const float so[3], const float sd[3], float dist) {
  float lv = 0.0f;
  const float* tr = T.tsh + (size_t)l * T.sh_tri_stride * ROW;
  for (int j = 0; j < T.n_tsh[l]; ++j) {
    float r[ROW];
    ld_row<ROW>(tr + j * ROW, r);
    lv += occ_fwd<false>(r, so, sd, dist, c);
  }
  const float* sr = T.ssh + (size_t)l * T.sh_sph_stride * ROW;
  for (int j = 0; j < T.n_ssh[l]; ++j) {
    float r[ROW];
    ld_row<ROW>(sr + j * ROW, r);
    lv += occ_fwd<true>(r, so, sd, dist, c);
  }
  return lv;
}

OCTRT_FN bool is_aggregate(int shading, bool shadows) {
  return shading == SHADE_PHONG || (shadows && shading == SHADE_LAMBERT);
}

// ---- the finals block of the stored-finals regime --------------------------
// One pixel's rows of it (the layout, and each row's name, are written down
// once, beside _FINALS_MIN_SLOTS in kernels/soft_tiled.py): aggregate shading
// [m, z, st, s[0..5], sn[0..2], bacc, logvis[0..nlv-1]], per-primitive
// shading [m, z, s[0..2], bacc]. p points at the pixel's first row, the rows
// `stride` floats apart (on the card: the 32 pixels of a patch, a row each).
// The logvis rows of a pixel that nothing covers are neither written nor
// read: the forward does not walk its occluders (pixel_finish), and the
// backward walks them itself where it reads such a pixel (pixel_bwd).
OCTRT_FN int fin_rows(bool agg, int nlv) { return agg ? 13 + nlv : 6; }

// 1 - w_bg is not exactly 0: the pixel's value depends on its shading.
OCTRT_FN bool fin_covered(const Fin& f) { return 1.0f - expf(f.bacc) != 0.0f; }

OCTRT_FN void fin_store(float* p, int stride, const Fin& f, bool agg, int nlv,
                        const float* logvis) {
  p[0] = f.m;
  p[stride] = f.z;
  if (!agg) {
    for (int a = 0; a < 3; ++a) p[(2 + a) * stride] = f.s[a];
    p[5 * stride] = f.bacc;
    return;
  }
  p[2 * stride] = f.st;
  for (int a = 0; a < 6; ++a) p[(3 + a) * stride] = f.s[a];
  for (int q = 0; q < 3; ++q) p[(9 + q) * stride] = f.sn[q];
  p[12 * stride] = f.bacc;
  if (nlv == 0 || !fin_covered(f)) return;
  for (int l = 0; l < nlv; ++l) p[(13 + l) * stride] = logvis[l];
}

// Returns true where it loaded the log-visibilities (nlv > 0 and the pixel
// covered).
OCTRT_FN bool fin_load(const float* p, int stride, Fin& f, bool agg, int nlv,
                       float* logvis) {
  fin_init(f);
  f.m = OCTRT_LDG(p);
  f.z = OCTRT_LDG(p + stride);
  if (!agg) {
    for (int a = 0; a < 3; ++a) f.s[a] = OCTRT_LDG(p + (2 + a) * stride);
    f.bacc = OCTRT_LDG(p + 5 * stride);
    return false;
  }
  f.st = OCTRT_LDG(p + 2 * stride);
  for (int a = 0; a < 6; ++a) f.s[a] = OCTRT_LDG(p + (3 + a) * stride);
  for (int q = 0; q < 3; ++q) f.sn[q] = OCTRT_LDG(p + (9 + q) * stride);
  f.bacc = OCTRT_LDG(p + 12 * stride);
  if (nlv == 0 || !fin_covered(f)) return false;
  for (int l = 0; l < nlv; ++l) logvis[l] = OCTRT_LDG(p + (13 + l) * stride);
  return true;
}

// Per-primitive shading (legacy, lambert without shadows): the pixel's rgb
// from the streaming finals, and the finals' cotangents from gout.
OCTRT_FN void nonagg_finish(const Fin& f, int shading, float out[3]) {
  const float zinv = 1.0f / fmaxf(f.z, 1e-20f);
  const float w_bg = expf(f.bacc);
  const float k = shading == SHADE_LEGACY ? 1.0f : 255.0f;
  for (int a = 0; a < 3; ++a) {
    const float y = (1.0f - w_bg) * (f.s[a] * k) * zinv;
    out[a] = shading == SHADE_LEGACY ? y : clipf(y, 0.0f, 255.0f);
  }
}

OCTRT_FN void nonagg_finish_bwd(const Fin& f, int shading, const float gout[3],
                                Cot& cot) {
  const float zinv = 1.0f / fmaxf(f.z, 1e-20f);
  const float w_bg = expf(f.bacc);
  const float k = shading == SHADE_LEGACY ? 1.0f : 255.0f;
  float g_zinv = 0.0f, g_wbg = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float s = f.s[a] * k;
    const float y = (1.0f - w_bg) * s * zinv;
    const float gy = shading == SHADE_LEGACY
                         ? gout[a] : gout[a] * gclip(y, 0.0f, 255.0f);
    cot.s[a] = gy * (1.0f - w_bg) * zinv * k;
    g_wbg -= gy * s * zinv;
    g_zinv += gy * (1.0f - w_bg) * s;
  }
  cot.bacc = g_wbg * w_bg;
  cot.z = g_zinv * (-zinv * zinv) * gmax(f.z, 1e-20f);
}

// Cotangents of one candidate's (t, cov, n, albedo) from the finals'
// cotangents, with the final m held constant (the output does not depend
// on it): adds into g_t, g_cov, gn, g_alb (ALB floats) and gc.
OCTRT_FN void cand_bwd(const Ctx& c, const Fin& f, const Cot& cot, bool agg,
                       int shading, float t, float cov, const float n[3],
                       const float* alb, float& g_t, float& g_cov, float gn[3],
                       float* g_alb, CtxGrad& gc) {
  const float e = expf(rank(t, cov, c) - f.m);
  float g_e = cot.z;
  if (agg) {
    g_e += cot.st * t;
    g_t += cot.st * e;
    for (int a = 0; a < 6; ++a) {
      g_e += cot.s[a] * alb[a];
      g_alb[a] += cot.s[a] * e;
    }
    for (int q = 0; q < 3; ++q) {
      g_e += cot.sn[q] * n[q];
      gn[q] += cot.sn[q] * e;
    }
  } else {
    nonagg_contrib_bwd(shading, c, t, n, alb, e, cot.s, g_e, g_t, gn, g_alb,
                       gc);
  }
  const float g_logit = g_e * e;
  g_cov += cot.bacc * g_log_unocc(cov);
  if (cov > 1e-12f) {
    g_t -= g_logit * c.inv_td;
    gc.inv_td -= g_logit * t;
    g_cov += g_logit / clipf(cov, 1e-12f, 1.0f) * gclip(cov, 1e-12f, 1.0f);
  }
}

// The forward of one pixel after its streaming pass: shading (and, for
// aggregate shading, the occluder loops) from the finals f -> rgb (0..255).
// A pixel that nothing covers (1 - w_bg is exactly 0) is exactly 0 whatever
// its shading and shadows are (0 times a finite colour): it takes no
// geometry, shading or occluder walk. logvis_out (or null): the
// log-visibilities of a covered pixel, for the finals block.
template <bool PROJ>
OCTRT_FN void pixel_finish(const Ctx& c, const Tabs& T, const Fin& f,
                           int shading, bool shadows, float out[3],
                           float* logvis_out = nullptr) {
  const bool agg = is_aggregate(shading, shadows);
  if (!agg) {
    nonagg_finish(f, shading, out);
    return;
  }
  out[0] = out[1] = out[2] = 0.0f;
  if (!fin_covered(f)) return;
  Geom G;
  geom_fwd(f, c, G);
  float logvis[MAX_L] = {0.f, 0.f, 0.f, 0.f};
  if (shadows) {
    for (int l = 0; l < c.nl; ++l) {
      logvis[l] = occ_logvis(c, T, l, G.so[l], G.sd[l], G.dist[l]);
      if (logvis_out != nullptr) logvis_out[l] = logvis[l];
    }
  }
  shade_agg_fwd(G, c, logvis, shading, shadows, out);
}

// The backward of one pixel. The threads that call it together (on the
// card: the 32 lanes of a warp, one 8 x 4 patch of one tile) share the
// tables, so the row loops are uniform and each row's gradient goes through
// `red`:
//   bool any(bool p): true if p holds for any of those threads;
//   template <int N> void add(float* dst, const float* v): dst[q] += the sum
//     of v[q] over those threads, q < N; all of them call it together.
// Threads with active == false (outside the frame, or with a zero
// cotangent: every gradient is linear in gout) only walk the loops and hand
// zeros to `red`. fin: null, or the pixel's rows of the finals block (rows
// fin_stride floats apart) that the forward wrote: the stored-finals regime,
// which reads the finals there in place of the streaming pass, and the
// log-visibilities of a covered pixel in place of its occluder walks. A
// pixel that nothing covers still walks its occluders: its value is 0, but
// d out / d w_bg there is the shaded colour (the clip's tie rule passes it
// half), which depends on each light's visibility, and w_bg on every
// candidate's coverage. An inactive thread reads nothing. A row whose gradient is zero in every thread is not
// summed at all, and a light's occluder reverse is skipped where no
// thread's d logvis is non-zero (every occluder gradient is linear in it).
// Row gradients are added into the d_* tables (laid out like the tables),
// the context gradients into gc.
struct DTabs {
  float *tri, *tri_alb, *sph, *sph_alb, *tsh, *ssh;
};

template <bool PROJ, class Red>
OCTRT_FN void pixel_bwd(const Ctx& c, const Tabs& T, int shading,
                        bool shadows, const float gout[3], bool active,
                        Red& red, const DTabs& D, CtxGrad& gc,
                        const float* fin = nullptr, int fin_stride = 0) {
  const bool agg = is_aggregate(shading, shadows);
  Fin f;
  Cot cot;
  Geom G;
  float logvis[MAX_L] = {0.f, 0.f, 0.f, 0.f};
  float g_logvis[MAX_L] = {0.f, 0.f, 0.f, 0.f};
  float g_so[MAX_L][3], g_sd[MAX_L][3], g_dist[MAX_L];
  float g_n[3] = {0.f, 0.f, 0.f}, g_a[3] = {0.f, 0.f, 0.f};
  float g_v[3] = {0.f, 0.f, 0.f}, g_wbg = 0.0f;
  for (int l = 0; l < MAX_L; ++l) {
    g_dist[l] = 0.0f;
    for (int q = 0; q < 3; ++q) g_so[l][q] = g_sd[l][q] = 0.0f;
  }
  if (active) {
    bool have_logvis = false;
    if (fin != nullptr) {
      have_logvis = fin_load(fin, fin_stride, f, agg, agg && shadows ? c.nl : 0,
                             logvis);
    } else {
      stream_finals<PROJ>(c, T, agg, shading, f);
    }
    if (agg) {
      geom_fwd(f, c, G);
      if (shadows && !have_logvis) {
        for (int l = 0; l < c.nl; ++l) {
          logvis[l] = occ_logvis(c, T, l, G.so[l], G.sd[l], G.dist[l]);
        }
      }
      shade_agg_bwd(G, c, logvis, shading, shadows, gout, g_n, g_a, g_v,
                    g_wbg, g_sd, g_logvis, gc);
    } else {
      nonagg_finish_bwd(f, shading, gout, cot);
    }
  }

  // ---- occluders, per light ----------------------------------------------
  if (agg && shadows) {
    for (int l = 0; l < c.nl; ++l) {
      const float glv = g_logvis[l];
      const bool act = active && glv != 0.0f;
      if (!red.any(act)) continue;
      for (int kind = 0; kind < 2; ++kind) {
        const int nrow = kind ? T.n_ssh[l] : T.n_tsh[l];
        const int stride = kind ? T.sh_sph_stride : T.sh_tri_stride;
        const float* rows = (kind ? T.ssh : T.tsh) + (size_t)l * stride * ROW;
        float* drows = (kind ? D.ssh : D.tsh) + (size_t)l * stride * ROW;
        for (int j = 0; j < nrow; ++j) {
          float gr[ROW];
          for (int q = 0; q < ROW; ++q) gr[q] = 0.0f;
          if (act) {
            float r[ROW];
            ld_row<ROW>(rows + j * ROW, r);
            if (kind) {
              occ_bwd<true>(r, G.so[l], G.sd[l], G.dist[l], c, glv, gr,
                            g_so[l], g_sd[l], g_dist[l], gc);
            } else {
              occ_bwd<false>(r, G.so[l], G.sd[l], G.dist[l], c, glv, gr,
                             g_so[l], g_sd[l], g_dist[l], gc);
            }
          }
          if (red.any(nonzero<ROW>(gr))) {
            red.template add<ROW>(drows + j * ROW, gr);
          }
        }
      }
    }
  }
  if (agg && active) {
    geom_bwd(f, c, G, g_n, g_a, g_v, g_wbg, g_sd, g_so, g_dist, cot, gc);
  }

  // ---- primary candidates, with the final m held constant -----------------
  for (int kind = 0; kind < 2; ++kind) {
    const int nrow = kind ? T.n_sph : T.n_tri;
    const float* rows = kind ? T.sph : T.tri;
    const float* albs = kind ? T.sph_alb : T.tri_alb;
    float* drows = kind ? D.sph : D.tri;
    float* dalbs = kind ? D.sph_alb : D.tri_alb;
    for (int j = 0; j < nrow; ++j) {
      float g[ROW + ALB];
      for (int q = 0; q < ROW + ALB; ++q) g[q] = 0.0f;
      if (active) {
        float r[ROW], alb[ALB];
        ld_row<ROW>(rows + j * ROW, r);
        ld_row<ALB>(albs + j * ALB, alb);
        float t, cov, n[3];
        if (kind) sph_fwd<PROJ>(r, c, t, cov, n);
        else tri_fwd<PROJ>(r, c, t, cov, n);
        float g_t = 0.0f, g_cov = 0.0f, gn[3] = {0.f, 0.f, 0.f};
        cand_bwd(c, f, cot, agg, shading, t, cov, n, alb, g_t, g_cov, gn,
                 g + ROW, gc);
        if (kind) sph_bwd<PROJ>(r, c, g_t, g_cov, gn, g, gc);
        else tri_bwd<PROJ>(r, c, g_t, g_cov, gn, g, gc);
      }
      if (red.any(nonzero<ROW + ALB>(g))) {
        red.template add<ROW>(drows + j * ROW, g);
        red.template add<ALB>(dalbs + j * ALB, g + ROW);
      }
    }
  }
}

// The tables of tile `tile`: pointers and processed row counts.
OCTRT_FN Tabs tile_tabs(const float* tri, const float* tri_alb,
                        const float* sph, const float* sph_alb,
                        const float* tsh, const float* ssh, const int* counts,
                        int tile, int k_tri, int k_sph, int sh_tri_stride,
                        int sh_sph_stride, int nl, bool proj) {
  Tabs T;
  const int* cnt = counts + (size_t)tile * (2 + 2 * nl);
  T.tri = tri + (size_t)tile * k_tri * ROW;
  T.tri_alb = tri_alb + (size_t)tile * k_tri * ALB;
  T.sph = sph + (size_t)tile * k_sph * ROW;
  T.sph_alb = sph_alb + (size_t)tile * k_sph * ALB;
  const size_t sh_tile = proj ? 0 : (size_t)tile;
  T.tsh = tsh + sh_tile * nl * sh_tri_stride * ROW;
  T.ssh = ssh + sh_tile * nl * sh_sph_stride * ROW;
  T.n_tri = processed(OCTRT_LDG(cnt), k_tri);
  T.n_sph = processed(OCTRT_LDG(cnt + 1), k_sph);
  T.sh_tri_stride = sh_tri_stride;
  T.sh_sph_stride = sh_sph_stride;
  for (int l = 0; l < MAX_L; ++l) {
    T.n_tsh[l] = l < nl ? processed(OCTRT_LDG(cnt + 2 + 2 * l), sh_tri_stride) : 0;
    T.n_ssh[l] = l < nl ? processed(OCTRT_LDG(cnt + 3 + 2 * l), sh_sph_stride) : 0;
  }
  return T;
}


// ==== the brute soft renderer (soft_brute.cu): every primitive, no tables ==
// Its rays are per pixel (o, d from the camera bundle), so the primary tests
// are the general-ray occluder tests above (tri_sh_*, sph_sh_*) plus a
// normal. Each primitive's raw operand column (tri_geo (14, Tp): v0, e1,
// e2, |e1|, |e2|, unit normal; sph_geo (4, Sp): centre, radius) is first
// derived into one ROW-float row of that layout:
//   triangle  [v0, e1, e2, itu, itv, itw, n (3, unflipped), 0]
//   sphere    [c, r2, inv2r, twor, rinv, 0 x 9]
// and a row's gradient is mapped back onto the raw column by *_row_bwd.

OCTRT_FN void tri_row_make(const float* geo, int stride, int i, float tau_e,
                           float* r) {
  for (int q = 0; q < 9; ++q) r[q] = OCTRT_LDG(geo + (size_t)q * stride + i);
  const float s1 = OCTRT_LDG(geo + (size_t)9 * stride + i);
  const float s2 = OCTRT_LDG(geo + (size_t)10 * stride + i);
  r[9] = fmaxf(s1, 1e-6f) / tau_e;
  r[10] = fmaxf(s2, 1e-6f) / tau_e;
  r[11] = fmaxf(0.5f * (s1 + s2), 1e-6f) / tau_e;
  for (int q = 0; q < 3; ++q) {
    r[12 + q] = OCTRT_LDG(geo + (size_t)(11 + q) * stride + i);
  }
  r[15] = 0.0f;
}

// gr: the row's gradient -> the raw column's gradient dcol[14]; returns the
// row's contribution to d tau_e.
OCTRT_FN float tri_row_bwd(const float* geo, int stride, int i, float tau_e,
                           const float* gr, float* dcol) {
  for (int q = 0; q < 9; ++q) dcol[q] = gr[q];
  const float s1 = OCTRT_LDG(geo + (size_t)9 * stride + i);
  const float s2 = OCTRT_LDG(geo + (size_t)10 * stride + i);
  const float h = 0.5f * (s1 + s2);
  const float gw = gr[11] * gmax(h, 1e-6f) * 0.5f;
  dcol[9] = (gr[9] * gmax(s1, 1e-6f) + gw) / tau_e;
  dcol[10] = (gr[10] * gmax(s2, 1e-6f) + gw) / tau_e;
  for (int q = 0; q < 3; ++q) dcol[11 + q] = gr[12 + q];
  const float k0 = fmaxf(s1, 1e-6f) / tau_e, k1 = fmaxf(s2, 1e-6f) / tau_e;
  const float k2 = fmaxf(h, 1e-6f) / tau_e;
  return -(gr[9] * k0 + gr[10] * k1 + gr[11] * k2) / tau_e;
}

OCTRT_FN void sph_row_make(const float* geo, int stride, int i, float* r) {
  for (int q = 0; q < 3; ++q) r[q] = OCTRT_LDG(geo + (size_t)q * stride + i);
  const float rad = OCTRT_LDG(geo + (size_t)3 * stride + i);
  const float twor = fmaxf(2.0f * rad, 1e-6f);
  r[3] = rad * rad;
  r[4] = 1.0f / twor;
  r[5] = twor;
  r[6] = rad > 0.0f ? 1.0f / rad : 0.0f;  // guarded: padded spheres have r = 0
  for (int q = 7; q < ROW; ++q) r[q] = 0.0f;
}

OCTRT_FN void sph_row_bwd(const float* geo, int stride, int i, const float* gr,
                          float* dcol) {
  for (int q = 0; q < 3; ++q) dcol[q] = gr[q];
  const float rad = OCTRT_LDG(geo + (size_t)3 * stride + i);
  const float twor = fmaxf(2.0f * rad, 1e-6f), inv2r = 1.0f / twor;
  float g = gr[3] * 2.0f * rad +
            (gr[5] - gr[4] * inv2r * inv2r) * 2.0f * gmax(2.0f * rad, 1e-6f);
  if (rad > 0.0f) g -= gr[6] / (rad * rad);
  dcol[3] = g;
}

// The brute pixel context: o and d from the camera bundle for either camera
// family (d = d0 + x ddx + y ddy, normalised for pinhole), in the order of
// the twin's _ray_bundle; every other field as ctx_make<false>.
template <bool NORM>
OCTRT_FN void brute_ctx_make(Ctx& c, const float* prm, float tau_d,
                             float tau_e, float x, float y, int nl) {
  ctx_make<false>(c, prm, tau_d, tau_e, x, y, nl);
  for (int q = 0; q < 3; ++q) {
    c.du[q] = OCTRT_LDG(prm + P_D0 + q) + x * OCTRT_LDG(prm + P_DDX + q) +
              y * OCTRT_LDG(prm + P_DDY + q);
    c.d[q] = c.du[q];
  }
  if (NORM) {
    c.len2 = c.du[0] * c.du[0] + c.du[1] * c.du[1] + c.du[2] * c.du[2];
    c.inv_len = 1.0f / sqrtf(c.len2);
    for (int q = 0; q < 3; ++q) c.d[q] = c.du[q] * c.inv_len;
  }
}

// Context gradients -> params / taus gradients; consumes g.d.
template <bool NORM>
OCTRT_FN void brute_ctx_bwd(const Ctx& c, CtxGrad& g, float tau_d, float* dprm,
                            float* dtau) {
  float gdu[3];
  if (NORM) {  // d = du * inv_len, inv_len = (du . du)^-1/2
    float g_inv = 0.0f;
    for (int q = 0; q < 3; ++q) g_inv += g.d[q] * c.du[q];
    const float il = c.inv_len;
    const float g_len2 = g_inv * (-0.5f * il * il * il);
    for (int q = 0; q < 3; ++q) gdu[q] = g.d[q] * il + 2.0f * c.du[q] * g_len2;
  } else {
    for (int q = 0; q < 3; ++q) gdu[q] = g.d[q];
  }
  for (int q = 0; q < 3; ++q) {
    dprm[P_D0 + q] += gdu[q];
    dprm[P_DDX + q] += c.x * gdu[q];
    dprm[P_DDY + q] += c.y * gdu[q];
    g.d[q] = 0.0f;
  }
  ctx_bwd<false>(c, g, tau_d, dprm, dtau);
}

// Primary test of one derived row for the pixel's own ray: the general-ray
// test plus the normal (triangles: the unit normal flipped against the ray;
// spheres: outward at the soft near intersection).
template <bool SPHERE>
OCTRT_FN void brute_prim_fwd(const float* r, const Ctx& c, float& t,
                             float& cov, float n[3]) {
  if (SPHERE) {
    sph_sh_fwd(r, c.o, c.d, c, t, cov);
    for (int q = 0; q < 3; ++q) n[q] = (c.o[q] + t * c.d[q] - r[q]) * r[6];
  } else {
    tri_sh_fwd(r, c.o, c.d, t, cov);
    const float nd = r[12] * c.d[0] + r[13] * c.d[1] + r[14] * c.d[2];
    const float fl = nd > 0.0f ? -1.0f : 1.0f;
    for (int q = 0; q < 3; ++q) n[q] = r[12 + q] * fl;
  }
}

template <bool SPHERE>
OCTRT_FN void brute_prim_bwd(const float* r, const Ctx& c, float gt, float gcov,
                             const float gn[3], float* gr, CtxGrad& gc) {
  if (SPHERE) {
    float t, cov;
    sph_sh_fwd(r, c.o, c.d, c, t, cov);
    for (int q = 0; q < 3; ++q) {  // n = (o + t d - ctr) * rinv
      gr[6] += gn[q] * (c.o[q] + t * c.d[q] - r[q]);
      const float tmp = gn[q] * r[6];
      gc.o[q] += tmp;
      gt += tmp * c.d[q];
      gc.d[q] += tmp * t;
      gr[q] -= tmp;
    }
    sph_sh_bwd(r, c.o, c.d, c, gt, gcov, gr, gc.o, gc.d, gc);
  } else {
    const float nd = r[12] * c.d[0] + r[13] * c.d[1] + r[14] * c.d[2];
    const float fl = nd > 0.0f ? -1.0f : 1.0f;
    for (int q = 0; q < 3; ++q) gr[12 + q] += gn[q] * fl;
    tri_sh_bwd(r, c.o, c.d, gt, gcov, gr, gc.o, gc.d);
  }
}

// The derived rows of a scene: triangles then spheres, real primitives only
// (a padded triangle is degenerate and a padded sphere lies at z = 1e9 with
// radius 0: both have zero weight wherever any real primitive has any, and
// a pixel no primitive covers is zeroed by 1 - w_bg = 0 either way).
//
// The pixel functions below take the rows through a `Rows` object, so that
// a kernel chooses where they come from (straight from device memory, or
// staged through shared memory) and which threads walk them together:
//   template <bool WITH_ALB, class F> void for_each(F f)
//     calls f(i, Kind<SPHERE>{}, r, alb) for every primitive i in order
//     (triangles, then spheres) with its ROW coefficients r and, if
//     WITH_ALB, its ALB albedo floats; every thread that shares the Rows
//     walks the same loop (it may hold barriers);
//   bool any(bool p): true if p holds for any of those threads.
template <bool SPHERE>
struct Kind {
  static constexpr bool sphere = SPHERE;
};

// The gradient sink of brute_pixel_bwd: `prim(i, g)` takes primitive i's
// ROW row gradients and, behind them, its 3 albedo gradients; `occ(i, gr)`
// the 12 row gradients of primitive i as an occluder. Every thread that
// shares the Rows calls both for every primitive (threads with nothing to
// add pass zeros), so an implementation may sum across them first.

template <class Rows>
OCTRT_FN void brute_stream_finals(const Ctx& c, Rows& B, bool active,
                                  bool aggregate, int shading, Fin& f) {
  fin_init(f);
  B.template for_each<true>(
      [&](int, auto kind, const float* r, const float* alb) {
        if (!active) return;
        float t, cov, n[3];
        brute_prim_fwd<decltype(kind)::sphere>(r, c, t, cov, n);
        stream_accum(c, t, cov, n, alb, aggregate, shading, f);
      });
}

// Soft shadows over every primitive: the sum of log(1 - occ) along one
// shadow ray.
template <class Rows>
OCTRT_FN float brute_occ_logvis(const Ctx& c, Rows& B, bool active,
                                const float so[3], const float sd[3],
                                float dist) {
  float lv = 0.0f;
  B.template for_each<false>(
      [&](int, auto kind, const float* r, const float*) {
        if (active) lv += occ_fwd<decltype(kind)::sphere>(r, so, sd, dist, c);
      });
  return lv;
}

// The forward of one pixel -> rgb (0..255); threads with active == false
// only walk the loops. A pixel that nothing covers (1 - w_bg is exactly 0)
// is exactly 0 whatever its shading and shadows are (0 times a finite
// colour), so it skips the finish and, where no thread sharing the Rows is
// covered, the occluder walks too.
template <class Rows>
OCTRT_FN void brute_pixel_fwd(const Ctx& c, Rows& B, int shading, bool shadows,
                              bool active, float out[3]) {
  const bool agg = is_aggregate(shading, shadows);
  Fin f;
  brute_stream_finals(c, B, active, agg, shading, f);
  out[0] = out[1] = out[2] = 0.0f;
  if (!agg) {
    if (active) nonagg_finish(f, shading, out);
    return;
  }
  const bool fin = active && 1.0f - expf(f.bacc) != 0.0f;
  Geom G;
  if (fin) geom_fwd(f, c, G);
  float logvis[MAX_L] = {0.f, 0.f, 0.f, 0.f};
  if (shadows && B.any(fin)) {
    for (int l = 0; l < c.nl; ++l) {
      logvis[l] = brute_occ_logvis(c, B, fin, G.so[l], G.sd[l],
                                   fin ? G.dist[l] : 0.0f);
    }
  }
  if (fin) shade_agg_fwd(G, c, logvis, shading, shadows, out);
}

// The backward of one pixel: recompute the finals, reverse shading and
// geometry once, then walk the occluders and the primitives again with the
// final m held constant. Threads with active == false (outside the frame,
// or with a zero cotangent: every gradient is linear in gout) only walk the
// loops and hand zeros to `red`. The occluder walk of a light is skipped
// where no thread's d logvis is non-zero: every occluder gradient is linear
// in it.
template <class Rows, class Red>
OCTRT_FN void brute_pixel_bwd(const Ctx& c, Rows& B, int shading, bool shadows,
                              const float gout[3], bool active, Red& red,
                              CtxGrad& gc) {
  const bool agg = is_aggregate(shading, shadows);
  Fin f;
  Cot cot;
  Geom G;
  float logvis[MAX_L] = {0.f, 0.f, 0.f, 0.f};
  float g_logvis[MAX_L] = {0.f, 0.f, 0.f, 0.f};
  float g_so[MAX_L][3], g_sd[MAX_L][3], g_dist[MAX_L];
  float g_n[3] = {0.f, 0.f, 0.f}, g_a[3] = {0.f, 0.f, 0.f};
  float g_v[3] = {0.f, 0.f, 0.f}, g_wbg = 0.0f;
  for (int l = 0; l < MAX_L; ++l) {
    g_dist[l] = 0.0f;
    for (int q = 0; q < 3; ++q) g_so[l][q] = g_sd[l][q] = 0.0f;
  }
  brute_stream_finals(c, B, active, agg, shading, f);
  if (agg) {
    if (active) geom_fwd(f, c, G);
    if (shadows) {
      for (int l = 0; l < c.nl; ++l) {
        logvis[l] = brute_occ_logvis(c, B, active, G.so[l], G.sd[l],
                                     active ? G.dist[l] : 0.0f);
      }
    }
    if (active) {
      shade_agg_bwd(G, c, logvis, shading, shadows, gout, g_n, g_a, g_v, g_wbg,
                    g_sd, g_logvis, gc);
    }
  } else if (active) {
    nonagg_finish_bwd(f, shading, gout, cot);
  }

  // ---- occluders, per light ------------------------------------------------
  if (agg && shadows) {
    for (int l = 0; l < c.nl; ++l) {
      const float glv = g_logvis[l];
      const bool act = active && glv != 0.0f;
      if (!B.any(act)) continue;
      float so[3], sd[3], gso[3] = {0.f, 0.f, 0.f}, gsd[3] = {0.f, 0.f, 0.f};
      float gdist = 0.0f;
      const float dist = act ? G.dist[l] : 0.0f;
      for (int q = 0; q < 3; ++q) {
        so[q] = act ? G.so[l][q] : 0.0f;
        sd[q] = act ? G.sd[l][q] : 0.0f;
      }
      B.template for_each<false>(
          [&](int i, auto kind, const float* r, const float*) {
            float gr[12];
            for (int q = 0; q < 12; ++q) gr[q] = 0.0f;
            if (act) {
              occ_bwd<decltype(kind)::sphere>(r, so, sd, dist, c, glv, gr, gso,
                                              gsd, gdist, gc);
            }
            red.occ(i, gr);
          });
      g_dist[l] += gdist;
      for (int q = 0; q < 3; ++q) {
        g_so[l][q] += gso[q];
        g_sd[l][q] += gsd[q];
      }
    }
  }
  if (agg && active) {
    geom_bwd(f, c, G, g_n, g_a, g_v, g_wbg, g_sd, g_so, g_dist, cot, gc);
  }

  // ---- primitives ------------------------------------------------------------
  B.template for_each<true>(
      [&](int i, auto kind, const float* r, const float* alb) {
        constexpr bool SPH = decltype(kind)::sphere;
        float g[ROW + ALB];
        for (int q = 0; q < ROW + ALB; ++q) g[q] = 0.0f;
        if (active) {
          float t, cov, n[3];
          brute_prim_fwd<SPH>(r, c, t, cov, n);
          float g_t = 0.0f, g_cov = 0.0f, gn[3] = {0.f, 0.f, 0.f};
          cand_bwd(c, f, cot, agg, shading, t, cov, n, alb, g_t, g_cov, gn,
                   g + ROW, gc);
          brute_prim_bwd<SPH>(r, c, g_t, g_cov, gn, g, gc);
        }
        red.prim(i, g);
      });
}

#ifdef __CUDACC__
// Does a pixel's cotangent reach anything? (Alpha is a constant.)
__device__ __forceinline__ bool has_cotangent(const float4 g) {
  return g.x != 0.0f || g.y != 0.0f || g.z != 0.0f;
}

// dst[q] += the sum over the warp of v[q], q < N <= NP (a power of two), one
// atomicAdd per non-zero sum, from the lane that ends up holding it. Every
// lane of the warp must call. The butterfly halves the values a lane holds
// at each of log2(NP) steps while it doubles the lanes summed into each,
// then finishes the rest of the five steps on its one value: value q ends
// in the lanes whose upper log2(NP) bits are q (NP shuffles, not 5 N).
template <int N, int NP>
__device__ __forceinline__ void warp_sum_add(float* dst, const float* v,
                                             int lane) {
  constexpr unsigned FULL_WARP = 0xffffffffu;
  float w[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) w[q] = q < N ? v[q] : 0.0f;
  int spare = 5;  // the lane's low bits that do not select a value
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int off = 16 >> s, cnt = NP >> (s + 1);
    if (cnt >= 1) {
      const bool hi = (lane & off) != 0;
#pragma unroll
      for (int q = 0; q < NP / 2; ++q) {
        if (q < cnt) {
          const float send = hi ? w[q] : w[q + cnt];
          const float keep = hi ? w[q + cnt] : w[q];
          w[q] = keep + __shfl_xor_sync(FULL_WARP, send, off);
        }
      }
      spare = 4 - s;
    } else {
      w[0] += __shfl_xor_sync(FULL_WARP, w[0], off);
    }
  }
  const int q = lane >> spare;
  if ((lane & ((1 << spare) - 1)) == 0 && q < N && w[0] != 0.0f) {
    atomicAdd(dst + q, w[0]);
  }
}

// Sum n <= N per-thread values over a block of THREADS_ threads, then one
// atomicAdd each. Every thread of the block must call it (it holds
// barriers). smem: [THREADS_ / 32][RED_W_] floats, RED_W_ >= N.
template <int THREADS_, int RED_W_>
struct BlockRedT {
  float* smem;
  template <int N>
  __device__ void add(float* dst, const float* v, int n = N) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = v[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off);
      }
      if (lane == 0) smem[warp * RED_W_ + i] = s;
    }
    __syncthreads();
    if ((int)threadIdx.x < n) {
      float s = 0.0f;
      for (int w = 0; w < THREADS_ / 32; ++w) s += smem[w * RED_W_ + threadIdx.x];
      if (s != 0.0f) atomicAdd(dst + threadIdx.x, s);
    }
    __syncthreads();
  }
};
#endif

}  // namespace octrt_soft
