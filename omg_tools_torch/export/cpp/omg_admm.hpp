// Distributed consensus-ADMM embedded runtime.
//
// Mirrors the reference's two-phase exported API
// (reference: omgtools/export/point2point/admm/ADMMPoint2Point.{hpp,cpp}):
// communication is the CALLER's job -- each agent exposes its shared
// vector and per-edge multipliers after update1 (the local x-update), the
// caller transports them to the ring neighbors (in-process, ROS topics,
// ...), and update2 runs the closed-form z-projection, the multiplier
// ascent, and the residuals locally.
//
// The consensus variable is the vehicle's perceived fleet-center spline
// coefficients s_i = S x_i + r_i (S = shared-coefficient selector, r_i the
// vehicle's relative formation offset broadcast per coefficient); the
// augmented objective lam'(s - z) + rho/2 ||s - z||^2 enters the local
// Gauss-Newton ALM solve through the Point2Point objective hooks.
#pragma once

#include "omg_runtime.hpp"

namespace omg {

class ADMMPoint2Point : public Point2Point {
 public:
  // rel_pos: the vehicle's formation offset per shared dimension
  // (length n_sh / n_coeffs); broadcast over the basis coefficients.
  ADMMPoint2Point(const std::string& export_dir,
                  const std::vector<double>& rel_pos,
                  SolverOptions options = SolverOptions());

  // Phase 1 (reference ADMMPoint2Point::update1): local x-update with the
  // current z/lam, trajectory sampling.  After this call ship shared() and
  // multiplier(slot) to the ring neighbors.
  // Pre-motion ADMM iteration (reference dualmethod.py:209-216): local
  // solve with the current z/lam WITHOUT advancing the MPC phase or
  // shifting the warm start.  Follow with update2 like a normal iteration.
  void solveIteration(const std::array<double, 2>& state0,
                      const std::array<double, 2>& input0,
                      const std::array<double, 2>& goal,
                      const std::vector<Obstacle>& obstacles);

  bool update1(const std::array<double, 2>& state0,
               const std::array<double, 2>& input0,
               const std::array<double, 2>& goal,
               const std::vector<Obstacle>& obstacles,
               std::array<double, 2>* next_state,
               std::array<double, 2>* next_input);

  // Phase 2 (reference ADMMPoint2Point::update2): neighbor data per slot
  // (slot 0 = next vehicle on the ring, slot 1 = previous), z-projection,
  // lam ascent, primal/dual residuals.
  void update2(const std::vector<std::vector<double>>& s_neighbor,
               const std::vector<std::vector<double>>& l_neighbor,
               double* primal_res, double* dual_res);

  const std::vector<double>& shared() const { return s_; }
  const std::vector<double>& multiplier(int slot) const { return l_[slot]; }
  const std::vector<double>& consensus(int slot) const { return z_[slot]; }
  int nShared() const { return n_sh_; }
  int nSlots() const { return n_slots_; }
  int iteration() const { return admm_iter_; }

 protected:
  void addObjGrad(std::vector<double>* grad) override;
  void addObjHess(std::vector<double>* H) override;
  double objExtraAt(const std::vector<double>& x) override;
  void onKnotShift() override;

 private:
  void computeShared();

  int n_sh_ = 0, n_slots_ = 0, admm_iter_ = 0;
  double rho_admm_ = 2.0;
  std::vector<long> S_idx_;             // shared-coefficient selector
  std::vector<double> rel_;             // r_i (n_sh)
  std::vector<double> s_;               // s_i = S x + r (n_sh)
  std::vector<std::vector<double>> z_;  // per slot (n_sh)
  std::vector<std::vector<double>> l_;  // per slot (n_sh)
};

}  // namespace omg
