// jetkit: native jet substructure kernels (kt clustering, N-subjettiness,
// energy correlation functions).
//
// Replacement for the reference's fastjet dependency
// (reference `utils/aoj.py:536-627` clusters with
// fastjet.kt_algorithm + WTA_pt_scheme and computes tau1/2/3, c1, d2, d0).
// fastjet is a C++ library consumed through Python bindings there; here the
// same observables are computed by this standalone C++ kernel exposed over
// a C ABI (ctypes), parallelized over jets with OpenMP.  Evaluation-only:
// this never touches the device path.
//
// Conventions:
//  - particles with pt <= 0 are padding
//  - jets with < 3 real particles are skipped (outputs = NaN), matching the
//    reference's `ak.num(...) >= 3` cut (`aoj.py:550`)
//  - exclusive kt jets: merge the min-dij pair (WTA pt recombination)
//    until n clusters remain
//
// Build: make -C native   (produces libjetkit.so)

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr float kNaN = std::numeric_limits<float>::quiet_NaN();

struct PseudoJet {
  double pt, eta, phi;
  bool active;
};

inline double wrap_dphi(double dphi) {
  const double pi = 3.14159265358979323846;
  dphi = std::fmod(dphi + pi, 2.0 * pi);
  if (dphi < 0) dphi += 2.0 * pi;
  return dphi - pi;
}

inline double delta_r2(const PseudoJet& a, const PseudoJet& b) {
  const double de = a.eta - b.eta;
  const double dp = wrap_dphi(a.phi - b.phi);
  return de * de + dp * dp;
}

// Exclusive kt clustering down to n_target clusters with winner-take-all
// pt recombination: the combined cluster takes the axis of the harder
// constituent and the scalar-pt sum.  Returns the surviving cluster axes.
void exclusive_kt_axes(const std::vector<PseudoJet>& parts, double R,
                       int n_target, std::vector<PseudoJet>& axes_out) {
  std::vector<PseudoJet> cl(parts);
  int n_active = static_cast<int>(cl.size());
  const double R2 = R * R;

  while (n_active > n_target) {
    double best = std::numeric_limits<double>::infinity();
    int bi = -1, bj = -1;
    for (size_t i = 0; i < cl.size(); ++i) {
      if (!cl[i].active) continue;
      for (size_t j = i + 1; j < cl.size(); ++j) {
        if (!cl[j].active) continue;
        const double kt2 = std::min(cl[i].pt * cl[i].pt, cl[j].pt * cl[j].pt);
        const double dij = kt2 * delta_r2(cl[i], cl[j]) / R2;
        if (dij < best) { best = dij; bi = static_cast<int>(i); bj = static_cast<int>(j); }
      }
    }
    if (bi < 0) break;  // nothing left to merge
    // WTA pt scheme: axis of the harder cluster, scalar pt sum
    PseudoJet& hard = (cl[bi].pt >= cl[bj].pt) ? cl[bi] : cl[bj];
    PseudoJet merged{cl[bi].pt + cl[bj].pt, hard.eta, hard.phi, true};
    cl[bi] = merged;
    cl[bj].active = false;
    --n_active;
  }

  axes_out.clear();
  for (const auto& c : cl)
    if (c.active) axes_out.push_back(c);
}

double tau_n(const std::vector<PseudoJet>& parts,
             const std::vector<PseudoJet>& axes, double beta, double d0) {
  double acc = 0.0;
  for (const auto& p : parts) {
    double best = std::numeric_limits<double>::infinity();
    for (const auto& a : axes) {
      const double dr = std::sqrt(delta_r2(p, a));
      const double v = std::pow(dr, beta);
      if (v < best) best = v;
    }
    acc += p.pt * best;
  }
  return acc / d0;
}

}  // namespace

extern "C" {

// Inputs: flat [n_jets, max_p] arrays of pt/eta/phi (pt<=0 = pad).
// Output: out[n_jets, 8] = {d0, tau1, tau2, tau3, tau21, tau32, c1, d2}.
void jetkit_substructure(const float* pt, const float* eta, const float* phi,
                         int64_t n_jets, int64_t max_p, float R, float beta,
                         float* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (int64_t j = 0; j < n_jets; ++j) {
    float* o = out + j * 8;
    std::vector<PseudoJet> parts;
    parts.reserve(max_p);
    for (int64_t p = 0; p < max_p; ++p) {
      const float pt_v = pt[j * max_p + p];
      if (pt_v > 0.0f)
        parts.push_back({pt_v, eta[j * max_p + p], phi[j * max_p + p], true});
    }
    if (parts.size() < 3) {
      for (int k = 0; k < 8; ++k) o[k] = kNaN;
      continue;
    }

    // d0 = sum_i pt_i * R^beta   (reference `aoj.py:577-579`)
    double sum_pt = 0.0;
    for (const auto& p : parts) sum_pt += p.pt;
    const double d0 = sum_pt * std::pow((double)R, (double)beta);

    std::vector<PseudoJet> axes1, axes2, axes3;
    exclusive_kt_axes(parts, R, 1, axes1);
    exclusive_kt_axes(parts, R, 2, axes2);
    exclusive_kt_axes(parts, R, 3, axes3);

    const double t1 = tau_n(parts, axes1, beta, d0);
    const double t2 = tau_n(parts, axes2, beta, d0);
    const double t3 = tau_n(parts, axes3, beta, d0);

    // Energy correlation functions (normalized):
    //   e2 = sum_{i<j} z_i z_j dR_ij^beta,  e3 adds the triple product;
    //   C1 = e2, D2 = e3 / e2^3  (fastjet func="c1"/"d2" conventions)
    double e2 = 0.0, e3 = 0.0;
    const size_t n = parts.size();
    std::vector<double> z(n);
    for (size_t i = 0; i < n; ++i) z[i] = parts[i].pt / sum_pt;
    std::vector<double> dr(n * n, 0.0);
    for (size_t a = 0; a < n; ++a)
      for (size_t b = a + 1; b < n; ++b) {
        const double v = std::pow(std::sqrt(delta_r2(parts[a], parts[b])), beta);
        dr[a * n + b] = v;
        e2 += z[a] * z[b] * v;
      }
    for (size_t a = 0; a < n; ++a)
      for (size_t b = a + 1; b < n; ++b)
        for (size_t c = b + 1; c < n; ++c)
          e3 += z[a] * z[b] * z[c] * dr[a * n + b] * dr[a * n + c] * dr[b * n + c];

    const double c1 = e2;
    const double d2 = (e2 > 0.0) ? e3 / (e2 * e2 * e2) : kNaN;

    o[0] = static_cast<float>(d0);
    o[1] = static_cast<float>(t1);
    o[2] = static_cast<float>(t2);
    o[3] = static_cast<float>(t3);
    o[4] = static_cast<float>((t1 > 0) ? t2 / t1 : kNaN);
    o[5] = static_cast<float>((t2 > 0) ? t3 / t2 : kNaN);
    o[6] = static_cast<float>(c1);
    o[7] = static_cast<float>(d2);
  }
}

// Flavor-masked auto/cross 2-point energy correlators
// (reference `utils/aoj.py:630-771`, which loops in Python per jet).
// mode: 0 = auto (tensor_2 ignored), 1 = cross.
// out[n_jets, 2] = {ecf, pT2}; jets failing the min-multiplicity cut get 0.
void jetkit_ecf2(const float* pt1, const float* eta1, const float* phi1,
                 const float* pt2, const float* eta2, const float* phi2,
                 int64_t n_jets, int64_t max_p, float beta, int mode,
                 float* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 32)
#endif
  for (int64_t j = 0; j < n_jets; ++j) {
    float* o = out + j * 2;
    std::vector<PseudoJet> a, b;
    for (int64_t p = 0; p < max_p; ++p) {
      const float v = pt1[j * max_p + p];
      if (v > 0.0f) a.push_back({v, eta1[j * max_p + p], phi1[j * max_p + p], true});
    }
    if (mode == 0) {
      if (a.size() < 2) { o[0] = 0.0f; o[1] = 0.0f; continue; }
      double sum_pt = 0.0;
      for (const auto& p : a) sum_pt += p.pt;
      const double pt2sum = sum_pt * sum_pt;
      double ecf = 0.0;
      for (size_t x = 0; x < a.size(); ++x)
        for (size_t y = x + 1; y < a.size(); ++y)
          ecf += a[x].pt * a[y].pt * std::pow(std::sqrt(delta_r2(a[x], a[y])), beta);
      o[0] = static_cast<float>(ecf / pt2sum);
      o[1] = static_cast<float>(pt2sum);
    } else {
      for (int64_t p = 0; p < max_p; ++p) {
        const float v = pt2[j * max_p + p];
        if (v > 0.0f) b.push_back({v, eta2[j * max_p + p], phi2[j * max_p + p], true});
      }
      if (a.empty() || b.empty()) { o[0] = 0.0f; o[1] = 0.0f; continue; }
      double s1 = 0.0, s2 = 0.0;
      for (const auto& p : a) s1 += p.pt;
      for (const auto& p : b) s2 += p.pt;
      const double pt2sum = s1 * s2;
      double ecf = 0.0;
      for (const auto& x : a)
        for (const auto& y : b)
          ecf += x.pt * y.pt * std::pow(std::sqrt(delta_r2(x, y)), beta);
      o[0] = static_cast<float>(ecf / pt2sum);
      o[1] = static_cast<float>(pt2sum);
    }
  }
}

// pT-weighted jet charge Q_kappa and electric-dipole moment d2
// (reference `utils/aoj.py:774-872`).
// out[n_jets, 3] = {Q0, Q_kappa, d2}; NaN where undefined.
void jetkit_charge_dipole(const float* pt, const float* eta, const float* phi,
                          const float* charge, int64_t n_jets, int64_t max_p,
                          float kappa, float beta, float* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 32)
#endif
  for (int64_t j = 0; j < n_jets; ++j) {
    float* o = out + j * 3;
    std::vector<PseudoJet> parts;
    std::vector<double> q;
    for (int64_t p = 0; p < max_p; ++p) {
      const float v = pt[j * max_p + p];
      if (v > 0.0f) {
        parts.push_back({v, eta[j * max_p + p], phi[j * max_p + p], true});
        q.push_back(charge[j * max_p + p]);
      }
    }
    double jet_pt = 0.0;
    for (const auto& p : parts) jet_pt += p.pt;

    if (jet_pt <= 0.0) { o[0] = kNaN; o[1] = kNaN; }
    else {
      double q0 = 0.0, qk = 0.0;
      for (size_t i = 0; i < parts.size(); ++i) {
        q0 += q[i];
        qk += q[i] * std::pow(parts[i].pt, (double)kappa);
      }
      o[0] = static_cast<float>(q0);
      o[1] = static_cast<float>(qk / jet_pt);
    }

    if (parts.size() < 2) { o[2] = kNaN; continue; }
    double dip = 0.0;
    for (size_t a = 0; a < parts.size(); ++a)
      for (size_t b = a + 1; b < parts.size(); ++b)
        dip += (q[a] * parts[a].pt) * (q[b] * parts[b].pt) *
               std::pow(std::sqrt(delta_r2(parts[a], parts[b])), (double)beta);
    o[2] = static_cast<float>(dip / (jet_pt * jet_pt));
  }
}

}  // extern "C"
