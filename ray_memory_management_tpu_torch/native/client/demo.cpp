// End-to-end exercise of the C++ frontend against a live cluster.
//
//   ./rmt_demo <host> <port> [authkey]
//
// Connects, round-trips an object through the store, invokes the
// cluster-registered "cpp_transform" function (bytes in -> bytes out),
// waits on the returned ref, fetches the result, and prints one
// machine-checkable line per step (the Python test asserts on these).

#include <cstdio>
#include <string>
#include <vector>

#include "rmt_client.hpp"

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <host> <port> [authkey]\n", argv[0]);
    return 2;
  }
  std::string host = argv[1];
  int port = std::stoi(argv[2]);
  std::string authkey = argc > 3 ? argv[3] : "rmt-client";

  try {
    rmt::Client client(host, port, authkey);
    std::printf("CONNECTED\n");

    auto resources = client.ClusterResources();
    std::printf("RESOURCES cpu=%.0f\n", resources.count("CPU")
                                            ? resources["CPU"]
                                            : -1.0);

    // object plane round trip
    std::string payload = "hello from c++ \x01\x02\xff";
    std::string oid = client.Put(payload);
    std::printf("PUT id_len=%zu\n", oid.size());
    auto values = client.Get({oid});
    std::printf("GET roundtrip=%s\n",
                values.size() == 1 && values[0] == payload ? "ok" : "MISMATCH");

    // duplicate-id fetch of a large payload: the server pickles the
    // repeated value as a memo BINGET, which the unpickler must resolve
    // (regression: the memo once skipped large bytes)
    std::string big(100 * 1024, 'x');
    std::string big_id = client.Put(big);
    auto twice = client.Get({big_id, big_id});
    std::printf("DUPGET %s\n",
                twice.size() == 2 && twice[0] == big && twice[1] == big
                    ? "ok"
                    : "MISMATCH");
    client.Free({big_id});

    // named-function call: cluster-side Python computes on our bytes
    auto names = client.ListFunctions();
    bool found = false;
    for (const auto& n : names) found = found || n == "cpp_transform";
    std::printf("NAMED registered=%s\n", found ? "yes" : "no");
    if (found) {
      auto rets = client.Call("cpp_transform", {"abc", "def"});
      std::printf("CALL returns=%zu\n", rets.size());
      auto split = client.Wait(rets, int(rets.size()), 60.0);
      std::printf("WAIT ready=%zu not_ready=%zu\n", split.first.size(),
                  split.second.size());
      auto results = client.Get(rets, 60.0);
      std::printf("RESULT %s\n", results[0].c_str());
      client.Free(rets);  // release the pinned returns
      std::printf("FREED\n");
    }
    client.Free({oid});
    std::printf("DEMO OK\n");
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "DEMO FAILED: %s\n", e.what());
    return 1;
  }
}
