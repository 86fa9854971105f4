// Multi-process distributed-ADMM agent: one OS process per vehicle, ring
// topology over TCP sockets -- the stand-in for the reference's ROS
// pub/sub wiring (reference examples/ros_example/src/p3dx_motionplanner/
// src/motionplanner.py:36-40), proving the caller-communicates contract of
// ADMMPoint2Point::update1/update2 across address spaces.
//
// Usage: ./admm_agent <export_dir> <agent_id> <n_agents> <port_base>
//
// Agent i listens on port_base+i (accepting agent i-1) and connects to
// port_base+((i+1)%N).  Per ADMM iteration each agent ships its shared
// vector + the neighbor-facing multiplier over both ring edges, then runs
// update2.  Agent 0 prints the residual trace and PASSED on success.
#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cassert>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "omg_admm.hpp"

namespace {

void sendVec(int fd, const std::vector<double>& v) {
  uint32_t n = static_cast<uint32_t>(v.size());
  uint32_t nn = htonl(n);
  if (write(fd, &nn, 4) != 4) { perror("write"); exit(1); }
  size_t bytes = n * sizeof(double);
  const char* p = reinterpret_cast<const char*>(v.data());
  size_t off = 0;
  while (off < bytes) {
    ssize_t w = write(fd, p + off, bytes - off);
    if (w <= 0) { perror("write"); exit(1); }
    off += static_cast<size_t>(w);
  }
}

std::vector<double> recvVec(int fd) {
  uint32_t nn = 0;
  size_t off = 0;
  char* hp = reinterpret_cast<char*>(&nn);
  while (off < 4) {
    ssize_t r = read(fd, hp + off, 4 - off);
    if (r <= 0) { perror("read"); exit(1); }
    off += static_cast<size_t>(r);
  }
  uint32_t n = ntohl(nn);
  std::vector<double> v(n);
  size_t bytes = n * sizeof(double);
  char* p = reinterpret_cast<char*>(v.data());
  off = 0;
  while (off < bytes) {
    ssize_t r = read(fd, p + off, bytes - off);
    if (r <= 0) { perror("read"); exit(1); }
    off += static_cast<size_t>(r);
  }
  return v;
}

int listenOn(int port) {
  int s = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(s, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(s, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    perror("bind");
    exit(1);
  }
  listen(s, 1);
  int c = accept(s, nullptr, nullptr);
  close(s);
  return c;
}

int connectTo(int port) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  for (int tries = 0; tries < 200; ++tries) {
    int s = socket(AF_INET, SOCK_STREAM, 0);
    if (connect(s, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0)
      return s;
    close(s);
    usleep(50 * 1000);
  }
  std::fprintf(stderr, "connect to %d failed\n", port);
  exit(1);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: admm_agent <dir> <agent_id> <n_agents> <port>\n");
    return 2;
  }
  const std::string dir = argv[1];
  const int id = std::atoi(argv[2]);
  const int N = std::atoi(argv[3]);
  const int port = std::atoi(argv[4]);

  // square formation offsets (matches test_formation.cpp)
  std::vector<std::array<double, 2>> rel(N);
  for (int i = 0; i < N; ++i) {
    const double a = 2.0 * M_PI * i / N + M_PI / 4.0;
    rel[i] = {0.4 * std::sqrt(2.0) * std::cos(a),
              0.4 * std::sqrt(2.0) * std::sin(a)};
  }
  const std::array<double, 2> center0{-1.5, -1.5};
  const std::array<double, 2> centerT{2.0, 2.0};

  omg::ADMMPoint2Point agent(
      dir, std::vector<double>{rel[id][0], rel[id][1]});
  std::array<double, 2> state{center0[0] - rel[id][0],
                              center0[1] - rel[id][1]};
  std::array<double, 2> input{0.0, 0.0};
  const std::array<double, 2> goal{centerT[0] - rel[id][0],
                                   centerT[1] - rel[id][1]};
  std::vector<omg::Obstacle> no_obstacles;

  // ring wiring: accept from the previous agent, connect to the next.
  // Even ids listen first to avoid a connect/accept deadlock cycle.
  int fd_prev, fd_next;
  if (id % 2 == 0) {
    fd_prev = listenOn(port + id);
    fd_next = connectTo(port + (id + 1) % N);
  } else {
    fd_next = connectTo(port + (id + 1) % N);
    fd_prev = listenOn(port + id);
  }

  auto iterate = [&](bool init_phase, double* pri, double* dua) {
    std::array<double, 2> next_state, next_input;
    if (init_phase) {
      agent.solveIteration(state, input, goal, no_obstacles);
    } else {
      agent.update1(state, input, goal, no_obstacles, &next_state,
                    &next_input);
      state = next_state;
      input = next_input;
    }
    // ship shared + the edge multipliers both ways over the ring:
    // to prev: (shared, multiplier(1));  to next: (shared, multiplier(0))
    sendVec(fd_prev, agent.shared());
    sendVec(fd_prev, agent.multiplier(1));
    sendVec(fd_next, agent.shared());
    sendVec(fd_next, agent.multiplier(0));
    std::vector<double> s_next = recvVec(fd_next);
    std::vector<double> l_next = recvVec(fd_next);
    std::vector<double> s_prev = recvVec(fd_prev);
    std::vector<double> l_prev = recvVec(fd_prev);
    agent.update2({s_next, s_prev}, {l_next, l_prev}, pri, dua);
  };

  double pri = 1e30, dua = 1e30, pri0 = -1.0;
  for (int it = 0; it < 5; ++it) {
    iterate(true, &pri, &dua);
    if (pri0 < 0.0) pri0 = pri;
    if (id == 0)
      std::printf("init %d: primal %.3e dual %.3e\n", it, pri, dua);
  }
  const double d0 = std::hypot(state[0] - goal[0], state[1] - goal[1]);
  for (int it = 0; it < 30; ++it) {
    iterate(false, &pri, &dua);
    if (id == 0 && it % 10 == 0)
      std::printf("mpc %d: primal %.3e dual %.3e pos (%.2f, %.2f)\n", it,
                  pri, dua, state[0], state[1]);
  }
  const double d1 = std::hypot(state[0] - goal[0], state[1] - goal[1]);
  close(fd_prev);
  close(fd_next);
  if (id == 0) {
    std::printf("agent0 distance: %.3f -> %.3f, primal %.3e (start %.3e)\n",
                d0, d1, pri, pri0);
    assert(pri < 0.5 * pri0);   // consensus residual decreased
    assert(d1 < 0.8 * d0);      // the fleet moves toward the goal
    std::printf("PASSED\n");
  }
  return 0;
}
