#include "omg_admm.hpp"

#include <algorithm>
#include <cmath>
#include <stdexcept>

namespace omg {

ADMMPoint2Point::ADMMPoint2Point(const std::string& dir,
                                 const std::vector<double>& rel_pos,
                                 SolverOptions options)
    : Point2Point(dir, options) {
  n_sh_ = static_cast<int>(data_.sc("n_sh"));
  n_slots_ = static_cast<int>(data_.sc("n_slots"));
  rho_admm_ = data_.sc("rho_admm");
  const Array& sidx = data_.arr("S_idx");
  S_idx_.resize(n_sh_);
  for (int k = 0; k < n_sh_; ++k)
    S_idx_[k] = static_cast<long>(sidx.data[k]);
  // rel_pos either matches n_sh directly (terminal-variable consensus,
  // rendezvous) or is a per-dimension offset broadcast over the basis
  // coefficients (spline-center consensus, formation)
  rel_.resize(n_sh_);
  if (static_cast<int>(rel_pos.size()) == n_sh_) {
    std::copy(rel_pos.begin(), rel_pos.end(), rel_.begin());
  } else if (static_cast<int>(rel_pos.size()) * n_coeffs_ == n_sh_) {
    const int n_dim_sh = n_sh_ / n_coeffs_;
    for (int d = 0; d < n_dim_sh; ++d)
      for (int c = 0; c < n_coeffs_; ++c)
        rel_[d * n_coeffs_ + c] = rel_pos[d];
  } else {
    throw std::runtime_error("rel_pos size mismatch");
  }
  s_.assign(n_sh_, 0.0);
  z_.assign(n_slots_, std::vector<double>(n_sh_, 0.0));
  l_.assign(n_slots_, std::vector<double>(n_sh_, 0.0));
  computeShared();
  for (int e = 0; e < n_slots_; ++e) z_[e] = s_;
}

void ADMMPoint2Point::computeShared() {
  for (int k = 0; k < n_sh_; ++k) s_[k] = x_[S_idx_[k]] + rel_[k];
}

// -- objective hooks: sum_e lam_e'(s - z_e) + rho/2 ||s - z_e||^2 ----------
void ADMMPoint2Point::addObjGrad(std::vector<double>* grad) {
  for (int k = 0; k < n_sh_; ++k) {
    double sk = x_[S_idx_[k]] + rel_[k];
    double gk = 0.0;
    for (int e = 0; e < n_slots_; ++e)
      gk += l_[e][k] + rho_admm_ * (sk - z_[e][k]);
    (*grad)[S_idx_[k]] += gk;
  }
}

void ADMMPoint2Point::addObjHess(std::vector<double>* H) {
  // d2/dx2 = rho * n_slots on the shared diagonal (lower triangle)
  for (int k = 0; k < n_sh_; ++k) {
    long i = S_idx_[k];
    (*H)[i * n_x_ + i] += rho_admm_ * n_slots_;
  }
}

double ADMMPoint2Point::objExtraAt(const std::vector<double>& x) {
  double m = 0.0;
  for (int k = 0; k < n_sh_; ++k) {
    double sk = x[S_idx_[k]] + rel_[k];
    for (int e = 0; e < n_slots_; ++e) {
      double diff = sk - z_[e][k];
      m += l_[e][k] * diff + 0.5 * rho_admm_ * diff * diff;
    }
  }
  return m;
}

void ADMMPoint2Point::onKnotShift() {
  // knot passage: shift z and lam with the shared-coefficient transform
  // (reference admm.py:477-491)
  const Array& T = data_.arr("sh_shift");
  std::vector<double> tmp(n_sh_, 0.0);
  for (int e = 0; e < n_slots_; ++e) {
    for (auto* vec : {&z_[e], &l_[e]}) {
      for (int i = 0; i < n_sh_; ++i) {
        double s = 0.0;
        const double* Ti = &T.data[static_cast<long>(i) * n_sh_];
        for (int j = 0; j < n_sh_; ++j) s += Ti[j] * (*vec)[j];
        tmp[i] = s;
      }
      *vec = tmp;
    }
  }
}

void ADMMPoint2Point::solveIteration(const std::array<double, 2>& state0,
                                     const std::array<double, 2>& input0,
                                     const std::array<double, 2>& goal,
                                     const std::vector<Obstacle>& obstacles) {
  buildParams(state0, input0, goal, obstacles);
  buildAffine();
  solve();
  computeShared();
  // first_ stays true: the first real update() must not knot-shift
}

bool ADMMPoint2Point::update1(const std::array<double, 2>& state0,
                              const std::array<double, 2>& input0,
                              const std::array<double, 2>& goal,
                              const std::vector<Obstacle>& obstacles,
                              std::array<double, 2>* next_state,
                              std::array<double, 2>* next_input) {
  bool ok = update(state0, input0, goal, obstacles, next_state, next_input);
  computeShared();
  return ok;
}

void ADMMPoint2Point::update2(
    const std::vector<std::vector<double>>& s_neighbor,
    const std::vector<std::vector<double>>& l_neighbor,
    double* primal_res, double* dual_res) {
  const Array& P = data_.arr("z_proj");
  double pri = 0.0, dua = 0.0;
  std::vector<double> avg(n_sh_), z_new(n_sh_);
  for (int e = 0; e < n_slots_; ++e) {
    for (int k = 0; k < n_sh_; ++k) {
      avg[k] = 0.5 * (s_[k] + l_[e][k] / rho_admm_ + s_neighbor[e][k]
                      + l_neighbor[e][k] / rho_admm_);
    }
    for (int i = 0; i < n_sh_; ++i) {
      double s = 0.0;
      const double* Pi = &P.data[static_cast<long>(i) * n_sh_];
      for (int j = 0; j < n_sh_; ++j) s += Pi[j] * avg[j];
      z_new[i] = s;
    }
    for (int k = 0; k < n_sh_; ++k) {
      dua = std::max(dua, rho_admm_ * std::fabs(z_new[k] - z_[e][k]));
      z_[e][k] = z_new[k];
      double diff = s_[k] - z_[e][k];
      l_[e][k] += rho_admm_ * diff;
      pri = std::max(pri, std::fabs(diff));
    }
  }
  ++admm_iter_;
  if (primal_res) *primal_res = pri;
  if (dual_res) *dual_res = dua;
}

}  // namespace omg
