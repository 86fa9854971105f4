// Embedded MPC runtime for omg_tools_tpu exported problems.
//
// Self-contained C++17: loads the structural-quadratic problem tensors
// (g(x,p) = c(p) + A(p) x + x'Qx with per-phase affine c/A), solves each
// control period with a dense Gauss-Newton augmented-Lagrangian method
// (the same algorithm as the Python/TPU solver, ops/alm.py), shifts the
// warm start over knot passages, and samples the solved splines.
//
// Mirrors the role of the reference's exported runtime
// (reference: omgtools/export/point2point/Point2Point.{hpp,cpp} +
// vehicles/Vehicle.{hpp,cpp}) without CasADi/Ipopt dependencies.
#pragma once

#include <array>
#include <cmath>
#include <map>
#include <string>
#include <vector>

namespace omg {

struct Array {
  std::vector<long> shape;
  std::vector<double> data;
  long size() const {
    long s = 1;
    for (long d : shape) s *= d;
    return s;
  }
};

struct ProblemData {
  std::map<std::string, double> scalars;
  std::map<std::string, Array> arrays;

  static ProblemData load(const std::string& dir);
  const Array& arr(const std::string& name) const { return arrays.at(name); }
  double sc(const std::string& name) const { return scalars.at(name); }
  bool has(const std::string& name) const { return scalars.count(name) > 0; }
};

// Dense Cholesky factorization/solve (in place, lower triangular).
bool cholesky(std::vector<double>& H, int n);
void cholSolve(const std::vector<double>& L, int n, std::vector<double>& b);

struct SolverOptions {
  int outer_iter = 40;
  int inner_iter = 8;
  double rho_init = 100.0;
  double rho_growth = 5.0;
  double rho_max = 1e4;
  double feas_tol = 1e-5;
  double stat_tol = 1e-3;
  double ridge_rel = 1e-6;
  double max_step = 10.0;
};

struct Obstacle {
  std::array<double, 2> position{0.0, 0.0};
  std::array<double, 2> velocity{0.0, 0.0};
  std::array<double, 2> acceleration{0.0, 0.0};
};

// The MPC stepper (reference Point2Point.cpp:124-231 analog).
class Point2Point {
 public:
  explicit Point2Point(const std::string& export_dir,
                       SolverOptions options = SolverOptions());

  // One control period: updates the internal warm start and returns the
  // predicted state/input at the next sample instant.  `phase` cycles
  // 0..n_phases-1 (knot passage shifts happen at phase wrap).
  bool update(const std::array<double, 2>& state0,
              const std::array<double, 2>& input0,
              const std::array<double, 2>& goal,
              const std::vector<Obstacle>& obstacles,
              std::array<double, 2>* next_state,
              std::array<double, 2>* next_input);

  // Sample the solved position splines at n equidistant points over the
  // remaining horizon (de Boor evaluation).
  void sampleTrajectory(int n, std::vector<double>* xy) const;

  // Spline-trajectory obstacle slots (reference export.py:446-476
  // traj_coeffs marshalling): the caller supplies a coefficient matrix
  // (n_b x n_dim, row-major) describing the obstacle position over the
  // horizon; when not refreshed, the runtime advances the stored
  // trajectory one control period per update via the exported re-basing
  // transform (the embedded analog of the batched rollout's propagation).
  void setTrajObstacle(int o, const std::vector<double>& coeffs);
  int nTrajObstacles() const { return static_cast<int>(tobs_off_.size()); }

  virtual ~Point2Point() = default;

  void reset();
  double feasibility() const { return feas_; }
  int phase() const { return phase_; }

 protected:
  // Extra-objective hooks for distributed variants: the consensus-ADMM
  // subclass adds lam'(s - z) + rho/2 ||s - z||^2 on the shared
  // coefficients (reference admm.py:63-115 / ADMMPoint2Point.cpp).
  virtual void addObjGrad(std::vector<double>* grad) { (void)grad; }
  virtual void addObjHess(std::vector<double>* H) { (void)H; }
  virtual double objExtraAt(const std::vector<double>& x) {
    (void)x;
    return 0.0;
  }
  // called when the warm start is shifted over a knot passage
  virtual void onKnotShift() {}

  void buildParams(const std::array<double, 2>& state0,
                   const std::array<double, 2>& input0,
                   const std::array<double, 2>& goal,
                   const std::vector<Obstacle>& obstacles);
  void buildAffine();   // c = c0 + C1 p ; A = A0 + TA p (sparse)
  void solve();

  ProblemData data_;
  SolverOptions opt_;
  int n_x_, n_g_, n_p_, n_phases_, n_coeffs_, n_spl_, degree_;
  int phase_ = 0;
  bool first_ = true;
  std::vector<double> x_, lam_, p_;
  double rho_, feas_ = 1e30;
  std::vector<double> c_, A_;        // per-solve affine pieces (A dense m*n)
  std::vector<double> gval_, J_, grad_, H_, dx_, yhat_;
  std::vector<int> tobs_off_, tobs_nb_, tobs_dim_;
  std::vector<std::vector<double>> tobs_coeffs_;
};

double evalSplinePoint(const std::vector<double>& knots, int degree,
                       const double* coeffs, int stride, double tau);

}  // namespace omg
