// Embedded-runtime test harness: 50 MPC iterations on the exported
// p2p_holonomic problem (reference export/tests/point2point/test.cpp
// analog).  Asserts solver feasibility and monotone progress to the goal.
#include <cassert>
#include <cmath>
#include <cstdio>

#include "omg_runtime.hpp"

int main(int argc, char** argv) {
  const std::string dir = argc > 1 ? argv[1] : ".";
  omg::Point2Point p2p(dir);

  std::array<double, 2> state{-1.5, -1.5};
  std::array<double, 2> input{0.0, 0.0};
  const std::array<double, 2> goal{2.0, 2.0};
  std::vector<omg::Obstacle> obstacles(3);
  obstacles[0].position = {-2.1, -0.5};
  obstacles[1].position = {1.7, -0.5};
  obstacles[2].position = {1.5, 0.5};

  const double d0 = std::hypot(state[0] - goal[0], state[1] - goal[1]);
  int ok_count = 0;
  for (int it = 0; it < 50; ++it) {
    std::array<double, 2> next_state, next_input;
    bool ok = p2p.update(state, input, goal, obstacles,
                         &next_state, &next_input);
    if (ok) ++ok_count;
    state = next_state;
    input = next_input;
    if (it % 10 == 0) {
      std::printf("it %2d  pos (%.3f, %.3f)  feas %.2e\n", it, state[0],
                  state[1], p2p.feasibility());
    }
  }
  const double d1 = std::hypot(state[0] - goal[0], state[1] - goal[1]);
  std::printf("distance to goal: %.3f -> %.3f (solved ok: %d/50)\n", d0, d1,
              ok_count);
  assert(ok_count >= 45);
  assert(d1 < 0.55 * d0);

  std::vector<double> traj;
  p2p.sampleTrajectory(11, &traj);
  std::printf("trajectory tail: (%.2f, %.2f)\n", traj[20], traj[21]);
  std::printf("PASSED\n");
  return 0;
}
