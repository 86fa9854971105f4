// Rendezvous embedded test: four ADMMPoint2Point agents whose consensus
// variable is the free terminal condition conT -- the fleet agrees on a
// meeting point (reference export/tests/rendezvous/test.cpp analog).
#include <cassert>
#include <cmath>
#include <cstdio>
#include <memory>
#include <vector>

#include "omg_admm.hpp"

int main(int argc, char** argv) {
  const std::string dir = argc > 1 ? argv[1] : ".";
  const int N = 4;
  // meeting offsets: all want to meet with these relative positions
  const double rel[N][2] = {
      {0.3, 0.3}, {0.3, -0.3}, {-0.3, -0.3}, {-0.3, 0.3}};
  const double starts[N][2] = {
      {-1.6, -1.6}, {1.6, -1.6}, {1.6, 1.6}, {-1.6, 1.6}};

  std::vector<std::unique_ptr<omg::ADMMPoint2Point>> agents;
  std::vector<std::array<double, 2>> state(N), input(N), goal(N);
  for (int i = 0; i < N; ++i) {
    agents.emplace_back(new omg::ADMMPoint2Point(
        dir, std::vector<double>{rel[i][0], rel[i][1]}));
    for (int k = 0; k < 2; ++k) {
      state[i][k] = starts[i][k];
      input[i][k] = 0.0;
      goal[i][k] = 0.0;  // poseT unused: terminal conditions are free
    }
  }
  std::vector<omg::Obstacle> no_obstacles;

  auto communicate_and_update2 = [&](double* pri, double* dua) {
    *pri = 0.0;
    *dua = 0.0;
    for (int i = 0; i < N; ++i) {
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

  double pri = 1e30, dua = 1e30;
  for (int it = 0; it < 5; ++it) {
    for (int i = 0; i < N; ++i)
      agents[i]->solveIteration(state[i], input[i], goal[i], no_obstacles);
    communicate_and_update2(&pri, &dua);
    std::printf("init %d: primal %.3e dual %.3e\n", it, pri, dua);
  }

  for (int it = 0; it < 50; ++it) {
    for (int i = 0; i < N; ++i) {
      std::array<double, 2> ns, ni;
      agents[i]->update1(state[i], input[i], goal[i], no_obstacles,
                         &ns, &ni);
      state[i] = ns;
      input[i] = ni;
    }
    communicate_and_update2(&pri, &dua);
    if (it % 10 == 0)
      std::printf("it %2d: primal %.3e dual %.3e pos0 (%.2f, %.2f)\n",
                  it, pri, dua, state[0][0], state[0][1]);
  }

  // perceived meeting points (shared = conT + rel) must agree pairwise
  double mismatch = 0.0;
  for (int i = 0; i < N; ++i) {
    int nxt = (i + 1) % N;
    for (int k = 0; k < agents[i]->nShared(); ++k)
      mismatch = std::max(mismatch, std::fabs(
          agents[i]->shared()[k] - agents[nxt]->shared()[k]));
  }
  // fleet contracted: agents moved toward a common region
  double spread0 = 0.0, spread1 = 0.0;
  for (int i = 0; i < N; ++i)
    for (int j = i + 1; j < N; ++j) {
      spread0 = std::max(spread0, std::hypot(starts[i][0] - starts[j][0],
                                             starts[i][1] - starts[j][1]));
      spread1 = std::max(spread1, std::hypot(state[i][0] - state[j][0],
                                             state[i][1] - state[j][1]));
    }
  std::printf("meeting mismatch %.4f  spread %.3f -> %.3f  primal %.3e\n",
              mismatch, spread0, spread1, pri);
  assert(mismatch < 5e-2);   // reference rendezvous.py stop criterion
  assert(spread1 < 0.7 * spread0);
  std::printf("PASSED\n");
  return 0;
}
