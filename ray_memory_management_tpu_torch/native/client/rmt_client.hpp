// C++ frontend for the ray_memory_management_tpu_torch cluster.
//
// Speaks the thin-client wire protocol (client/server.py — authenticated
// multiprocessing.connection frames carrying pickled request/reply dicts)
// directly from C++: length-prefixed frames, the mutual HMAC-SHA256
// challenge handshake, and a small pickle subset for the request/reply
// dictionaries. Values cross the boundary as raw bytes via the server's
// put_bytes/get_bytes/call_named verbs; compute stays registered
// cluster-side by name (register_named_function) — the same opaque-buffer
// boundary the reference draws between its language frontends (its
// msgpack XLANG format), re-drawn over this runtime's native protocol.
//
// Counterpart of the reference's C++ frontend (cpp/src/ray/api.cc): the
// subset here is the driver surface (connect / put / get / call / wait),
// not a C++ worker runtime — tasks execute in the cluster's Python
// workers, which is where the CUDA compute path lives anyway.
//
// No dependencies beyond POSIX sockets and the C++17 standard library;
// SHA-256/HMAC are implemented in rmt_client.cpp.

#pragma once

#include <cstdint>
#include <functional>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace rmt {

// One decoded Python value from a reply dict (the subset the server
// actually sends: None/bool/int/float/str/bytes and lists/tuples/dicts
// of those).
struct PyVal {
  enum class Kind { None, Bool, Int, Float, Str, Bytes, List, Dict };
  Kind kind = Kind::None;
  bool b = false;
  int64_t i = 0;
  double f = 0.0;
  std::string s;                 // Str and small Bytes payloads
  // large Bytes payloads live behind a shared pointer so copying a
  // PyVal (pickle memo entries, duplicate-id fetches) never duplicates
  // a multi-GB buffer
  std::shared_ptr<const std::string> big;
  std::vector<PyVal> list;       // List (and tuples, decoded as lists)
  std::map<std::string, PyVal> dict;

  bool is_none() const { return kind == Kind::None; }
  const std::string& bytes() const {
    if (kind != Kind::Bytes && kind != Kind::Str)
      throw std::runtime_error("PyVal: not bytes");
    return big ? *big : s;
  }
};

class ClientError : public std::runtime_error {
 public:
  explicit ClientError(const std::string& what) : std::runtime_error(what) {}
};

// Synchronous client: one connection, one in-flight request at a time
// (the server replies per-request; pipelining is unnecessary for a
// driver frontend).
class Client {
 public:
  // host:port of a ClusterServer (serve() side prints/returns it).
  Client(const std::string& host, int port,
         const std::string& authkey = "rmt-client");
  ~Client();
  Client(const Client&) = delete;
  Client& operator=(const Client&) = delete;

  // Raw-bytes object plane.
  std::string Put(const std::string& data);                  // -> object id
  std::vector<std::string> Get(const std::vector<std::string>& ids,
                               double timeout_s = -1.0);     // -> values
  // Invoke a cluster-side function registered via
  // register_named_function(name, fn); args arrive as bytes.
  std::vector<std::string> Call(const std::string& name,
                                const std::vector<std::string>& args,
                                int num_cpus = -1);          // -> return ids
  // wait(): ids split into (ready, not_ready) after num_returns are done
  // or timeout_s elapses (negative = wait forever).
  std::pair<std::vector<std::string>, std::vector<std::string>> Wait(
      const std::vector<std::string>& ids, int num_returns,
      double timeout_s = -1.0);
  // Release results/puts this connection pinned (the server otherwise
  // holds them until disconnect); call after fetching what you need.
  void Free(const std::vector<std::string>& ids);
  std::vector<std::string> ListFunctions();
  std::map<std::string, double> ClusterResources();
  void Close();

  // Generic verb escape hatch: send one request dict (a "type" entry
  // names the verb), return the reply. Raises ClientError when the reply
  // carries a server-side error. The Executor below is built on this.
  PyVal Rpc(std::map<std::string, PyVal> msg);

 private:
  PyVal Request(std::map<std::string, PyVal> msg);
  void SendFrame(const std::string& payload);
  std::string RecvFrame(size_t max = (1u << 31) - 1);
  void Handshake(const std::string& authkey);

  int fd_ = -1;
  int64_t req_counter_ = 0;
};

// Worker-side C++ API: implement task functions IN C++ and serve them to
// the cluster. The executor registers its function names over the client
// protocol (client/server.py register_cpp_executor), long-polls for
// dispatched tasks, runs them, and returns result bytes; Python callers
// use api.cpp_function(name).remote(...) and ordinary ObjectRefs.
// Counterpart of the reference's C++ worker executing RAY_REMOTE
// functions (cpp/include/ray/api.h ray::Task(fn).Remote()) — re-drawn
// over this runtime's authenticated wire protocol with the same
// opaque-bytes cross-language boundary as the thin client.
class Executor {
 public:
  // A task function: raw bytes args in, one result (or num_returns
  // results) out. Throwing std::exception fails the task cluster-side
  // with the exception text.
  using Fn = std::function<std::vector<std::string>(
      const std::vector<std::string>&)>;

  Executor(const std::string& host, int port,
           const std::string& authkey = "rmt-client");

  // Register before Start(); name is what Python callers use.
  void Register(const std::string& name, Fn fn);
  // Announce the registered functions to the cluster. Called implicitly
  // by the first ServeOne/ServeForever.
  void Start();
  // One long-poll round: waits up to poll_timeout_s for a task, runs it,
  // replies. Returns true if a task was served.
  bool ServeOne(double poll_timeout_s = 5.0);
  // Serve until the connection drops (ClientError propagates).
  void ServeForever();

 private:
  Client client_;
  std::map<std::string, Fn> fns_;
  std::string ex_id_;
  bool started_ = false;
};

// Helpers for building request values (exposed for tests).
PyVal PvNone();
PyVal PvBool(bool v);
PyVal PvInt(int64_t v);
PyVal PvFloat(double v);
PyVal PvStr(const std::string& v);
PyVal PvBytes(std::string v);
PyVal PvList(std::vector<PyVal> v);

// Pickle subset codec (exposed for tests).
std::string PickleDict(const std::map<std::string, PyVal>& d);
PyVal Unpickle(const std::string& data);

}  // namespace rmt
