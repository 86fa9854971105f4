#include "omg_runtime.hpp"

#include <algorithm>
#include <cassert>
#include <cstdio>
#include <fstream>
#include <sstream>

namespace omg {

// ---------------------------------------------------------------- loading
ProblemData ProblemData::load(const std::string& dir) {
  ProblemData pd;
  std::ifstream meta(dir + "/meta.txt");
  if (!meta) throw std::runtime_error("cannot open meta.txt in " + dir);
  std::string line;
  while (std::getline(meta, line)) {
    std::istringstream ss(line);
    std::string kind, name;
    ss >> kind >> name;
    if (kind == "scalar") {
      double v;
      ss >> v;
      pd.scalars[name] = v;
    } else if (kind == "array") {
      int ndim;
      ss >> ndim;
      Array a;
      for (int k = 0; k < ndim; ++k) {
        long d;
        ss >> d;
        a.shape.push_back(d);
      }
      std::ifstream bin(dir + "/data/" + name + ".bin", std::ios::binary);
      if (!bin) throw std::runtime_error("missing data for " + name);
      a.data.resize(a.size());
      bin.read(reinterpret_cast<char*>(a.data.data()),
               a.size() * sizeof(double));
      pd.arrays[name] = std::move(a);
    }
  }
  return pd;
}

// ------------------------------------------------------------- linalg bits
bool cholesky(std::vector<double>& H, int n) {
  // in-place lower Cholesky; returns false if not PD
  for (int j = 0; j < n; ++j) {
    double d = H[j * n + j];
    for (int k = 0; k < j; ++k) d -= H[j * n + k] * H[j * n + k];
    if (d <= 0.0) return false;
    d = std::sqrt(d);
    H[j * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double s = H[i * n + j];
      for (int k = 0; k < j; ++k) s -= H[i * n + k] * H[j * n + k];
      H[i * n + j] = s / d;
    }
  }
  return true;
}

void cholSolve(const std::vector<double>& L, int n, std::vector<double>& b) {
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * b[k];
    b[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * b[k];
    b[i] = s / L[i * n + i];
  }
}

// ------------------------------------------------------------ spline eval
double evalSplinePoint(const std::vector<double>& knots, int degree,
                       const double* coeffs, int stride, double tau) {
  // de Boor's algorithm (reference Vehicle.cpp:159-196 analog)
  int n = static_cast<int>(knots.size()) - degree - 1;
  tau = std::min(std::max(tau, knots.front()), knots.back());
  int span = degree;
  for (int i = degree; i < n; ++i) {
    if (tau < knots[i + 1] || i == n - 1) {
      span = i;
      break;
    }
    span = i;
  }
  std::vector<double> d(degree + 1);
  for (int j = 0; j <= degree; ++j)
    d[j] = coeffs[(span - degree + j) * stride];
  for (int r = 1; r <= degree; ++r) {
    for (int j = degree; j >= r; --j) {
      int i = span - degree + j;
      double denom = knots[i + degree - r + 1] - knots[i];
      double alpha = denom > 0.0 ? (tau - knots[i]) / denom : 0.0;
      d[j] = (1.0 - alpha) * d[j - 1] + alpha * d[j];
    }
  }
  return d[degree];
}

// -------------------------------------------------------------- the stepper
Point2Point::Point2Point(const std::string& dir, SolverOptions options)
    : data_(ProblemData::load(dir)), opt_(options) {
  n_x_ = static_cast<int>(data_.sc("n_x"));
  n_g_ = static_cast<int>(data_.sc("n_g"));
  n_p_ = static_cast<int>(data_.sc("n_p"));
  n_phases_ = static_cast<int>(data_.sc("n_phases"));
  n_coeffs_ = static_cast<int>(data_.sc("n_coeffs"));
  n_spl_ = static_cast<int>(data_.sc("n_spl"));
  degree_ = static_cast<int>(data_.sc("spline_degree"));
  opt_.rho_init = data_.sc("rho_init");
  opt_.rho_max = data_.sc("rho_max");
  const int n_tobs = data_.has("n_traj_obstacles")
                         ? static_cast<int>(data_.sc("n_traj_obstacles"))
                         : 0;
  for (int o = 0; o < n_tobs; ++o) {
    tobs_off_.push_back(
        static_cast<int>(data_.sc("tobs" + std::to_string(o) + "_coeffs")));
    tobs_nb_.push_back(
        static_cast<int>(data_.sc("tobs" + std::to_string(o) + "_nb")));
    tobs_dim_.push_back(
        static_cast<int>(data_.sc("tobs" + std::to_string(o) + "_dim")));
  }
  reset();
}

void Point2Point::setTrajObstacle(int o, const std::vector<double>& coeffs) {
  tobs_coeffs_[o] = coeffs;
}

void Point2Point::reset() {
  x_ = data_.arr("x_init").data;
  lam_.assign(n_g_, 0.0);
  p_ = data_.arr("p_base").data;
  rho_ = opt_.rho_init;
  phase_ = 0;
  first_ = true;
  tobs_coeffs_.clear();
  for (size_t o = 0; o < tobs_off_.size(); ++o) {
    const int n = tobs_nb_[o] * tobs_dim_[o];
    tobs_coeffs_.emplace_back(p_.begin() + tobs_off_[o],
                              p_.begin() + tobs_off_[o] + n);
  }
}

void Point2Point::buildParams(const std::array<double, 2>& state0,
                              const std::array<double, 2>& input0,
                              const std::array<double, 2>& goal,
                              const std::vector<Obstacle>& obstacles) {
  p_ = data_.arr("p_base").data;
  const int i_t = static_cast<int>(data_.sc("i_t"));
  const int i_s = static_cast<int>(data_.sc("i_state0"));
  const int i_u = static_cast<int>(data_.sc("i_input0"));
  const int i_g = static_cast<int>(data_.sc("i_poseT"));
  p_[i_t] = phase_ * data_.sc("update_time");
  for (int k = 0; k < 2; ++k) {
    p_[i_s + k] = state0[k];
    p_[i_u + k] = input0[k];
    p_[i_g + k] = goal[k];
  }
  const int n_obs = static_cast<int>(data_.sc("n_obstacles"));
  for (int o = 0; o < n_obs && o < static_cast<int>(obstacles.size()); ++o) {
    int ix = static_cast<int>(data_.sc("obs" + std::to_string(o) + "_x"));
    int iv = static_cast<int>(data_.sc("obs" + std::to_string(o) + "_v"));
    int ia = static_cast<int>(data_.sc("obs" + std::to_string(o) + "_a"));
    for (int k = 0; k < 2; ++k) {
      p_[ix + k] = obstacles[o].position[k];
      p_[iv + k] = obstacles[o].velocity[k];
      p_[ia + k] = obstacles[o].acceleration[k];
    }
  }
  for (size_t o = 0; o < tobs_off_.size(); ++o) {
    const std::vector<double>& cf = tobs_coeffs_[o];
    for (size_t j = 0; j < cf.size(); ++j) p_[tobs_off_[o] + j] = cf[j];
  }
}

void Point2Point::buildAffine() {
  const Array& c0 = data_.arr("c0");
  const Array& C1 = data_.arr("C1");
  c_.assign(n_g_, 0.0);
  const double* c0p = &c0.data[phase_ * n_g_];
  const double* C1p = &C1.data[static_cast<long>(phase_) * n_g_ * n_p_];
  for (int k = 0; k < n_g_; ++k) {
    double v = c0p[k];
    for (int q = 0; q < n_p_; ++q) v += C1p[k * n_p_ + q] * p_[q];
    c_[k] = v;
  }
  A_.assign(static_cast<long>(n_g_) * n_x_, 0.0);
  const Array& a_idx = data_.arr("A0_idx");
  const Array& a_val = data_.arr("A0_val");
  for (long e = 0; e < a_idx.shape[0]; ++e) {
    int ph = static_cast<int>(a_idx.data[e * 3 + 0]);
    if (ph != phase_) continue;
    int k = static_cast<int>(a_idx.data[e * 3 + 1]);
    int i = static_cast<int>(a_idx.data[e * 3 + 2]);
    A_[static_cast<long>(k) * n_x_ + i] += a_val.data[e];
  }
  const Array& t_idx = data_.arr("TA_idx");
  const Array& t_val = data_.arr("TA_val");
  for (long e = 0; e < t_idx.shape[0]; ++e) {
    int ph = static_cast<int>(t_idx.data[e * 4 + 0]);
    if (ph != phase_) continue;
    int k = static_cast<int>(t_idx.data[e * 4 + 1]);
    int i = static_cast<int>(t_idx.data[e * 4 + 2]);
    int q = static_cast<int>(t_idx.data[e * 4 + 3]);
    A_[static_cast<long>(k) * n_x_ + i] += t_val.data[e] * p_[q];
  }
}

void Point2Point::solve() {
  const Array& q_idx = data_.arr("Q_idx");
  const Array& q_val = data_.arr("Q_val");
  const std::vector<double>& lb = data_.arr("lb").data;
  const std::vector<double>& ub = data_.arr("ub").data;
  const double* gf = &data_.arr("gf").data[phase_ * n_x_];
  const long nnz = q_idx.shape[0];

  gval_.assign(n_g_, 0.0);
  J_.assign(static_cast<long>(n_g_) * n_x_, 0.0);
  yhat_.assign(n_g_, 0.0);
  grad_.assign(n_x_, 0.0);
  H_.assign(static_cast<long>(n_x_) * n_x_, 0.0);
  dx_.assign(n_x_, 0.0);

  double prev_feas = 1e30;
  for (int outer = 0; outer < opt_.outer_iter; ++outer) {
    for (int inner = 0; inner < opt_.inner_iter; ++inner) {
      // J(x) = A + 2 Q x and g(x) = c + 0.5 (A + J) x (exact for the
      // quadratic structure)
      std::copy(A_.begin(), A_.end(), J_.begin());
      for (long e = 0; e < nnz; ++e) {
        int k = static_cast<int>(q_idx.data[e * 3 + 0]);
        int i = static_cast<int>(q_idx.data[e * 3 + 1]);
        int j = static_cast<int>(q_idx.data[e * 3 + 2]);
        double v = q_val.data[e];
        J_[static_cast<long>(k) * n_x_ + j] += v * x_[i];
        J_[static_cast<long>(k) * n_x_ + i] += v * x_[j];
      }
      for (int k = 0; k < n_g_; ++k) {
        const double* Jk = &J_[static_cast<long>(k) * n_x_];
        const double* Ak = &A_[static_cast<long>(k) * n_x_];
        double s = 0.0;
        for (int i = 0; i < n_x_; ++i) s += 0.5 * (Jk[i] + Ak[i]) * x_[i];
        gval_[k] = c_[k] + s;
      }
      // multiplier estimate + gradient
      for (int k = 0; k < n_g_; ++k) {
        double r = gval_[k] + lam_[k] / rho_;
        double proj = std::min(std::max(r, lb[k]), ub[k]);
        yhat_[k] = rho_ * (r - proj);
      }
      for (int i = 0; i < n_x_; ++i) grad_[i] = gf[i];
      for (int k = 0; k < n_g_; ++k) {
        if (yhat_[k] == 0.0) continue;
        const double* Jk = &J_[static_cast<long>(k) * n_x_];
        for (int i = 0; i < n_x_; ++i) grad_[i] += Jk[i] * yhat_[k];
      }
      addObjGrad(&grad_);
      // Gauss-Newton Hessian over active rows
      std::fill(H_.begin(), H_.end(), 0.0);
      double diag_max = 1.0;
      for (int k = 0; k < n_g_; ++k) {
        if (yhat_[k] == 0.0) continue;
        const double* Jk = &J_[static_cast<long>(k) * n_x_];
        for (int i = 0; i < n_x_; ++i) {
          if (Jk[i] == 0.0) continue;
          for (int j = 0; j <= i; ++j)
            H_[static_cast<long>(i) * n_x_ + j] += rho_ * Jk[i] * Jk[j];
        }
      }
      addObjHess(&H_);  // hook adds to the LOWER triangle (j <= i)
      for (int i = 0; i < n_x_; ++i)
        diag_max = std::max(diag_max, H_[static_cast<long>(i) * n_x_ + i]);
      double ridge = opt_.ridge_rel * diag_max + 1e-8;
      for (int i = 0; i < n_x_; ++i)
        H_[static_cast<long>(i) * n_x_ + i] += ridge;
      // mirror to upper triangle for the factorization
      for (int i = 0; i < n_x_; ++i)
        for (int j = i + 1; j < n_x_; ++j)
          H_[static_cast<long>(i) * n_x_ + j] =
              H_[static_cast<long>(j) * n_x_ + i];
      std::vector<double> L = H_;
      if (!cholesky(L, n_x_)) {
        for (int i = 0; i < n_x_; ++i)
          H_[static_cast<long>(i) * n_x_ + i] += 1e-3 * diag_max;
        L = H_;
        if (!cholesky(L, n_x_)) break;
      }
      for (int i = 0; i < n_x_; ++i) dx_[i] = -grad_[i];
      cholSolve(L, n_x_, dx_);
      // trust cap
      double dmax = 0.0;
      for (int i = 0; i < n_x_; ++i) dmax = std::max(dmax, std::fabs(dx_[i]));
      if (dmax > opt_.max_step)
        for (int i = 0; i < n_x_; ++i) dx_[i] *= opt_.max_step / dmax;
      // exact quadratic line search on the AL merit
      std::vector<double> Jd(n_g_, 0.0), qd(n_g_, 0.0);
      for (int k = 0; k < n_g_; ++k) {
        const double* Jk = &J_[static_cast<long>(k) * n_x_];
        double s = 0.0;
        for (int i = 0; i < n_x_; ++i) s += Jk[i] * dx_[i];
        Jd[k] = s;
      }
      for (long e = 0; e < nnz; ++e) {
        int k = static_cast<int>(q_idx.data[e * 3 + 0]);
        int i = static_cast<int>(q_idx.data[e * 3 + 1]);
        int j = static_cast<int>(q_idx.data[e * 3 + 2]);
        qd[k] += q_val.data[e] * dx_[i] * dx_[j];
      }
      double df = 0.0;
      for (int i = 0; i < n_x_; ++i) df += gf[i] * dx_[i];
      std::vector<double> xa(n_x_);
      auto merit_at = [&](double a) {
        for (int i = 0; i < n_x_; ++i) xa[i] = x_[i] + a * dx_[i];
        double m = a * df + objExtraAt(xa);
        for (int k = 0; k < n_g_; ++k) {
          double g_a = gval_[k] + a * Jd[k] + a * a * qd[k];
          double r = g_a + lam_[k] / rho_;
          double proj = std::min(std::max(r, lb[k]), ub[k]);
          double t = r - proj;
          m += 0.5 * rho_ * t * t;
        }
        return m;
      };
      double m0 = merit_at(0.0);
      static const double cands[] = {1.0, 0.5, 0.25, 0.1, 0.04, 0.015,
                                     6e-3, 2.5e-3, 1e-3, 4e-4, 1.5e-4};
      double alpha = 0.0;
      double slope = 0.0;
      for (int i = 0; i < n_x_; ++i) slope += grad_[i] * dx_[i];
      for (double a : cands) {
        if (merit_at(a) <= m0 + 1e-4 * a * slope) {
          alpha = a;
          break;
        }
      }
      if (alpha == 0.0) break;
      for (int i = 0; i < n_x_; ++i) x_[i] += alpha * dx_[i];
    }
    // outer: feasibility, multiplier update, penalty growth
    std::copy(c_.begin(), c_.end(), gval_.begin());
    for (long e = 0; e < nnz; ++e) {
      int k = static_cast<int>(q_idx.data[e * 3 + 0]);
      int i = static_cast<int>(q_idx.data[e * 3 + 1]);
      int j = static_cast<int>(q_idx.data[e * 3 + 2]);
      gval_[k] += q_val.data[e] * x_[i] * x_[j];
    }
    // A x contribution
    for (int k = 0; k < n_g_; ++k) {
      const double* Ak = &A_[static_cast<long>(k) * n_x_];
      double s = 0.0;
      for (int i = 0; i < n_x_; ++i) s += Ak[i] * x_[i];
      gval_[k] += s;  // gval = c + quad (above) + A x
    }
    double feas = 0.0;
    for (int k = 0; k < n_g_; ++k) {
      double viol = std::max(lb[k] - gval_[k], 0.0)
                    + std::max(gval_[k] - ub[k], 0.0);
      feas = std::max(feas, viol);
      double r = gval_[k] + lam_[k] / rho_;
      double proj = std::min(std::max(r, lb[k]), ub[k]);
      lam_[k] = rho_ * (r - proj);
    }
    feas_ = feas;
    if (feas > 0.25 * std::min(prev_feas, 1e6) && feas > opt_.feas_tol)
      rho_ = std::min(rho_ * opt_.rho_growth, opt_.rho_max);
    prev_feas = feas;
    if (feas < opt_.feas_tol && outer >= 2) break;
  }
}

bool Point2Point::update(const std::array<double, 2>& state0,
                         const std::array<double, 2>& input0,
                         const std::array<double, 2>& goal,
                         const std::vector<Obstacle>& obstacles,
                         std::array<double, 2>* next_state,
                         std::array<double, 2>* next_input) {
  if (!first_ && phase_ == 0) {
    // knot passage: shift the warm start (reference transformSplines)
    const Array& M = data_.arr("shift_M");
    std::vector<double> xs(n_x_, 0.0);
    for (int i = 0; i < n_x_; ++i) {
      double s = 0.0;
      const double* Mi = &M.data[static_cast<long>(i) * n_x_];
      for (int j = 0; j < n_x_; ++j) s += Mi[j] * x_[j];
      xs[i] = s;
    }
    x_ = xs;
    onKnotShift();
  }
  buildParams(state0, input0, goal, obstacles);
  buildAffine();
  solve();
  first_ = false;
  // sample next state/input from the solved splines (E0/E1 rows)
  const Array& E0 = data_.arr("E0");
  const Array& E1 = data_.arr("E1");
  const int i_spl = static_cast<int>(data_.sc("i_splines_start"));
  const double horizon = data_.sc("horizon_time");
  const int row = phase_ + 1;
  for (int k = 0; k < 2; ++k) {
    double s0 = 0.0, s1 = 0.0;
    for (int c = 0; c < n_coeffs_; ++c) {
      double coeff = x_[i_spl + c * n_spl_ + k];
      s0 += E0.data[row * n_coeffs_ + c] * coeff;
      s1 += E1.data[row * n_coeffs_ + c] * coeff;
    }
    (*next_state)[k] = s0;
    (*next_input)[k] = s1 / horizon;
  }
  phase_ = (phase_ + 1) % n_phases_;
  // advance the trajectory-obstacle splines one control period (the
  // caller can overwrite with setTrajObstacle before the next update)
  for (size_t o = 0; o < tobs_off_.size(); ++o) {
    const Array& M = data_.arr("traj_shift" + std::to_string(o));
    const int nb = tobs_nb_[o], nd = tobs_dim_[o];
    std::vector<double> nc(static_cast<size_t>(nb) * nd, 0.0);
    for (int i = 0; i < nb; ++i)
      for (int j = 0; j < nb; ++j) {
        const double m = M.data[static_cast<long>(i) * nb + j];
        for (int k = 0; k < nd; ++k)
          nc[static_cast<size_t>(i) * nd + k] +=
              m * tobs_coeffs_[o][static_cast<size_t>(j) * nd + k];
      }
    tobs_coeffs_[o] = nc;
  }
  return feas_ < 1e-3;
}

void Point2Point::sampleTrajectory(int n, std::vector<double>* xy) const {
  const std::vector<double>& knots = data_.arr("knots").data;
  const int i_spl = static_cast<int>(data_.sc("i_splines_start"));
  xy->assign(2 * n, 0.0);
  for (int s = 0; s < n; ++s) {
    double tau = static_cast<double>(s) / (n - 1);
    for (int k = 0; k < 2; ++k) {
      (*xy)[2 * s + k] = evalSplinePoint(
          knots, degree_, &x_[i_spl + k], n_spl_, tau);
    }
  }
}

}  // namespace omg
