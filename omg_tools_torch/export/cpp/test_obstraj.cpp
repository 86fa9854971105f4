// Spline-trajectory obstacle harness: the exported problem carries one
// trajectory-obstacle slot; the caller supplies the coefficient spline once
// and the runtime advances it one control period per update (reference
// examples/p2p_holonomic_obstraj_export.py + export.py:446-476).
#include <cassert>
#include <cmath>
#include <cstdio>

#include "omg_runtime.hpp"

int main(int argc, char** argv) {
  const std::string dir = argc > 1 ? argv[1] : ".";
  omg::Point2Point p2p(dir);
  assert(p2p.nTrajObstacles() == 1);

  std::array<double, 2> state{-1.5, -1.5};
  std::array<double, 2> input{0.0, 0.0};
  const std::array<double, 2> goal{2.0, 2.0};
  std::vector<omg::Obstacle> obstacles(1);
  obstacles[0].position = {1.7, -0.5};

  // obstacle drifts from (1.5, 0.5) toward (0.5, 0.9) over the horizon:
  // 13 cubic coefficients x 2 dims, linear-in-coefficients straight line
  const int nb = 13, nd = 2;
  std::vector<double> cf(nb * nd);
  for (int i = 0; i < nb; ++i) {
    const double w = static_cast<double>(i) / (nb - 1);
    cf[i * nd + 0] = 1.5 + w * (0.5 - 1.5);
    cf[i * nd + 1] = 0.5 + w * (0.9 - 0.5);
  }
  p2p.setTrajObstacle(0, cf);

  const double d0 = std::hypot(state[0] - goal[0], state[1] - goal[1]);
  int ok_count = 0;
  for (int it = 0; it < 50; ++it) {
    std::array<double, 2> next_state, next_input;
    bool ok = p2p.update(state, input, goal, obstacles,
                         &next_state, &next_input);
    if (ok) ++ok_count;
    state = next_state;
    input = next_input;
    if (it % 10 == 0)
      std::printf("it %2d  pos (%.3f, %.3f)  feas %.2e\n", it, state[0],
                  state[1], p2p.feasibility());
  }
  const double d1 = std::hypot(state[0] - goal[0], state[1] - goal[1]);
  std::printf("distance to goal: %.3f -> %.3f (solved ok: %d/50)\n", d0, d1,
              ok_count);
  assert(ok_count >= 45);
  // the detour around the drifting obstacle legitimately costs progress
  // vs the static-obstacle harness (test.cpp uses 0.55)
  assert(d1 < 0.65 * d0);
  std::printf("PASSED\n");
  return 0;
}
