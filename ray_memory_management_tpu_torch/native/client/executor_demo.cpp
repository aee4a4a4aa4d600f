// Demo C++ task executor (worker-side C++ API): registers three task
// functions and serves them to the cluster. Driven by
// tests/test_torch_cpp_worker.py against a live ClusterServer; the reference's
// analog is a C++ worker executing RAY_REMOTE functions
// (cpp/src/ray/runtime/task/task_executor.cc).

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "rmt_client.hpp"

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s host port\n", argv[0]);
    return 2;
  }
  try {
    rmt::Executor ex(argv[1], std::atoi(argv[2]));
    ex.Register("add_i64", [](const std::vector<std::string>& args) {
      long long total = 0;
      for (const auto& a : args) total += std::strtoll(a.c_str(), nullptr, 10);
      return std::vector<std::string>{std::to_string(total)};
    });
    ex.Register("rev", [](const std::vector<std::string>& args) {
      std::string s = args.empty() ? std::string() : args[0];
      return std::vector<std::string>{std::string(s.rbegin(), s.rend())};
    });
    ex.Register("boom",
                [](const std::vector<std::string>&) -> std::vector<std::string> {
                  throw std::runtime_error("kaboom");
                });
    ex.Register("sleep_ms", [](const std::vector<std::string>& args) {
      long ms = args.empty() ? 0 : std::strtol(args[0].c_str(), nullptr, 10);
      std::this_thread::sleep_for(std::chrono::milliseconds(ms));
      return std::vector<std::string>{std::string("slept")};
    });
    ex.Start();
    std::printf("EXECUTOR READY\n");
    std::fflush(stdout);
    ex.ServeForever();
  } catch (const std::exception& e) {
    // connection loss at cluster shutdown is the normal exit
    std::fprintf(stderr, "executor exit: %s\n", e.what());
  }
  return 0;
}
