// Distributed-formation embedded test: four ADMMPoint2Point agents wired
// in-process on a ring (the caller moves the shared vectors -- reference
// export/tests/formation/test.cpp analog).  5 init ADMM iterations, then
// 50 MPC periods with one ADMM iteration each; asserts residual decay and
// fleet progress toward the formation goal.
#include <cassert>
#include <cmath>
#include <cstdio>
#include <memory>
#include <vector>

#include "omg_admm.hpp"

int main(int argc, char** argv) {
  const std::string dir = argc > 1 ? argv[1] : ".";
  const int N = 4;
  // square formation offsets r_i (vehicle + r = fleet center)
  const double rel[N][2] = {
      {0.4, 0.4}, {0.4, -0.4}, {-0.4, -0.4}, {-0.4, 0.4}};
  const std::array<double, 2> center0{-1.5, -1.5};
  const std::array<double, 2> centerT{2.0, 2.0};

  std::vector<std::unique_ptr<omg::ADMMPoint2Point>> agents;
  std::vector<std::array<double, 2>> state(N), input(N), goal(N);
  for (int i = 0; i < N; ++i) {
    agents.emplace_back(new omg::ADMMPoint2Point(
        dir, std::vector<double>{rel[i][0], rel[i][1]}));
    for (int k = 0; k < 2; ++k) {
      state[i][k] = center0[k] - rel[i][k];
      input[i][k] = 0.0;
      goal[i][k] = centerT[k] - rel[i][k];
    }
  }
  std::vector<omg::Obstacle> no_obstacles;

  auto communicate_and_update2 = [&](double* pri, double* dua) {
    *pri = 0.0;
    *dua = 0.0;
    for (int i = 0; i < N; ++i) {
      // slot 0 = edge (i, i+1): neighbor i+1 holds it as its slot 1;
      // slot 1 = edge (i-1, i): neighbor i-1 holds it as its slot 0.
      int nxt = (i + 1) % N, prv = (i - 1 + N) % N;
      std::vector<std::vector<double>> s_nb{agents[nxt]->shared(),
                                            agents[prv]->shared()};
      std::vector<std::vector<double>> l_nb{agents[nxt]->multiplier(1),
                                            agents[prv]->multiplier(0)};
      double p, d;
      agents[i]->update2(s_nb, l_nb, &p, &d);
      *pri = std::max(*pri, p);
      *dua = std::max(*dua, d);
    }
  };

  // init iterations before motion (reference dualmethod.py:209-216)
  double pri = 1e30, dua = 1e30;
  for (int it = 0; it < 5; ++it) {
    for (int i = 0; i < N; ++i)
      agents[i]->solveIteration(state[i], input[i], goal[i], no_obstacles);
    communicate_and_update2(&pri, &dua);
    std::printf("init %d: primal %.3e dual %.3e\n", it, pri, dua);
  }
  const double pri_init = pri;

  double d0 = 0.0;
  for (int i = 0; i < N; ++i)
    d0 += std::hypot(state[i][0] - goal[i][0], state[i][1] - goal[i][1]);

  int ok_count = 0;
  for (int it = 0; it < 50; ++it) {
    for (int i = 0; i < N; ++i) {
      std::array<double, 2> ns, ni;
      bool ok = agents[i]->update1(state[i], input[i], goal[i],
                                   no_obstacles, &ns, &ni);
      if (ok) ++ok_count;
      state[i] = ns;
      input[i] = ni;
    }
    communicate_and_update2(&pri, &dua);
    if (it % 10 == 0)
      std::printf("it %2d: primal %.3e dual %.3e pos0 (%.2f, %.2f)\n",
                  it, pri, dua, state[0][0], state[0][1]);
  }

  double d1 = 0.0, form_err = 0.0;
  for (int i = 0; i < N; ++i) {
    d1 += std::hypot(state[i][0] - goal[i][0], state[i][1] - goal[i][1]);
    // formation error: perceived centers must agree pairwise
    int nxt = (i + 1) % N;
    for (int k = 0; k < 2; ++k) {
      double ci = state[i][k] + rel[i][k];
      double cj = state[nxt][k] + rel[nxt][k];
      form_err = std::max(form_err, std::fabs(ci - cj));
    }
  }
  std::printf("progress: %.3f -> %.3f  formation err %.4f  primal %.3e "
              "(init %.3e)  ok %d/200\n",
              d0, d1, form_err, pri, pri_init, ok_count);
  assert(d1 < 0.55 * d0);           // fleet moved toward the goal
  assert(form_err < 0.15);          // formation held
  assert(ok_count > 150);           // solves feasible
  std::printf("PASSED\n");
  return 0;
}
