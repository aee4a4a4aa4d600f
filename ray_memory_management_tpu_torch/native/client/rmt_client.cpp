// Implementation of the C++ thin-client frontend. See rmt_client.hpp.
//
// Wire stack, bottom to top:
//   1. TCP socket (blocking, TCP_NODELAY)
//   2. multiprocessing.connection frames: 4-byte big-endian signed length;
//      a -1 sentinel promotes to an 8-byte big-endian unsigned length
//   3. mutual HMAC challenge auth (CPython's deliver/answer_challenge:
//      b"#CHALLENGE#{sha256}<32 random bytes>" -> b"{sha256}<mac>" ->
//      b"#WELCOME#", then the same with roles swapped)
//   4. pickled request/reply dicts (a protocol-3 subset on the way out —
//      CPython unpickles any protocol; a protocol-5 subset reader on the
//      way in, which is what the server's pickler emits)

#include "rmt_client.hpp"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstring>
#include <fstream>
#include <random>

namespace rmt {

// ---------------------------------------------------------------- sha256
// Compact SHA-256 (FIPS 180-4), sufficient for the HMAC handshake.
namespace sha256 {

struct Ctx {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buflen = 0;
};

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void Init(Ctx* c) {
  static const uint32_t h0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                 0xa54ff53a, 0x510e527f, 0x9b05688c,
                                 0x1f83d9ab, 0x5be0cd19};
  std::memcpy(c->h, h0, sizeof(h0));
  c->len = 0;
  c->buflen = 0;
}

static void Block(Ctx* c, const uint8_t* p) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
           (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = c->h[0], b = c->h[1], cc = c->h[2], d = c->h[3], e = c->h[4],
           f = c->h[5], g = c->h[6], h = c->h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & cc) ^ (b & cc);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = cc; cc = b; b = a; a = t1 + t2;
  }
  c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
  c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

static void Update(Ctx* c, const void* data, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  c->len += n;
  while (n) {
    size_t take = std::min(n, sizeof(c->buf) - c->buflen);
    std::memcpy(c->buf + c->buflen, p, take);
    c->buflen += take;
    p += take;
    n -= take;
    if (c->buflen == 64) {
      Block(c, c->buf);
      c->buflen = 0;
    }
  }
}

static void Final(Ctx* c, uint8_t out[32]) {
  uint64_t bitlen = c->len * 8;
  uint8_t pad = 0x80;
  Update(c, &pad, 1);
  uint8_t zero = 0;
  while (c->buflen != 56) Update(c, &zero, 1);
  uint8_t lenb[8];
  for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bitlen >> (56 - 8 * i));
  Update(c, lenb, 8);  // bitlen was captured before padding
  for (int i = 0; i < 8; i++) {
    out[4 * i] = uint8_t(c->h[i] >> 24);
    out[4 * i + 1] = uint8_t(c->h[i] >> 16);
    out[4 * i + 2] = uint8_t(c->h[i] >> 8);
    out[4 * i + 3] = uint8_t(c->h[i]);
  }
}

static std::string Digest(const std::string& data) {
  Ctx c;
  Init(&c);
  Update(&c, data.data(), data.size());
  uint8_t out[32];
  Final(&c, out);
  return std::string(reinterpret_cast<char*>(out), 32);
}

}  // namespace sha256

static std::string HmacSha256(const std::string& key,
                              const std::string& message) {
  std::string k = key;
  if (k.size() > 64) k = sha256::Digest(k);
  k.resize(64, '\0');
  std::string ipad(64, '\x36'), opad(64, '\x5c');
  for (int i = 0; i < 64; i++) {
    ipad[i] ^= k[i];
    opad[i] ^= k[i];
  }
  return sha256::Digest(opad + sha256::Digest(ipad + message));
}

// ---------------------------------------------------------------- PyVal
PyVal PvNone() { return PyVal{}; }
PyVal PvBool(bool v) {
  PyVal p; p.kind = PyVal::Kind::Bool; p.b = v; return p;
}
PyVal PvInt(int64_t v) {
  PyVal p; p.kind = PyVal::Kind::Int; p.i = v; return p;
}
PyVal PvFloat(double v) {
  PyVal p; p.kind = PyVal::Kind::Float; p.f = v; return p;
}
PyVal PvStr(const std::string& v) {
  PyVal p; p.kind = PyVal::Kind::Str; p.s = v; return p;
}
PyVal PvBytes(std::string v) {
  // by value + move: the unpickler hands in a temporary, so a large
  // payload is materialized exactly once (no transient double-buffer)
  PyVal p;
  p.kind = PyVal::Kind::Bytes;
  if (v.size() > 4096) {
    p.big = std::make_shared<const std::string>(std::move(v));
  } else {
    p.s = std::move(v);
  }
  return p;
}
PyVal PvList(std::vector<PyVal> v) {
  PyVal p; p.kind = PyVal::Kind::List; p.list = std::move(v); return p;
}

// ---------------------------------------------------------------- pickler
namespace {

void PutLE32(std::string* out, uint32_t v) {
  out->push_back(char(v & 0xff));
  out->push_back(char((v >> 8) & 0xff));
  out->push_back(char((v >> 16) & 0xff));
  out->push_back(char((v >> 24) & 0xff));
}

void PickleValue(std::string* out, const PyVal& v) {
  switch (v.kind) {
    case PyVal::Kind::None:
      out->push_back('N');
      break;
    case PyVal::Kind::Bool:
      out->push_back(v.b ? '\x88' : '\x89');
      break;
    case PyVal::Kind::Int:
      if (v.i >= INT32_MIN && v.i <= INT32_MAX) {
        out->push_back('J');  // BININT, 4-byte LE signed
        PutLE32(out, uint32_t(int32_t(v.i)));
      } else {
        out->push_back('\x8a');  // LONG1 <nbytes> <LE signed>
        out->push_back(8);
        uint64_t u = uint64_t(v.i);
        for (int i = 0; i < 8; i++) out->push_back(char((u >> (8 * i)) & 0xff));
      }
      break;
    case PyVal::Kind::Float: {
      out->push_back('G');  // BINFLOAT, 8-byte BE double
      uint64_t bits;
      std::memcpy(&bits, &v.f, 8);
      for (int i = 7; i >= 0; i--) out->push_back(char((bits >> (8 * i)) & 0xff));
      break;
    }
    case PyVal::Kind::Str:
      out->push_back('X');  // BINUNICODE <LE32 len> <utf8>
      PutLE32(out, uint32_t(v.s.size()));
      out->append(v.s);
      break;
    case PyVal::Kind::Bytes: {
      const std::string& payload = v.bytes();
      if (payload.size() > UINT32_MAX)
        throw ClientError(
            "bytes payload exceeds the 4 GiB BINBYTES limit");
      out->push_back('B');  // BINBYTES (protocol 3) <LE32 len> <raw>
      PutLE32(out, uint32_t(payload.size()));
      out->append(payload);
      break;
    }
    case PyVal::Kind::List:
      out->push_back(']');  // EMPTY_LIST
      if (!v.list.empty()) {
        out->push_back('(');  // MARK
        for (const auto& item : v.list) PickleValue(out, item);
        out->push_back('e');  // APPENDS
      }
      break;
    case PyVal::Kind::Dict: {
      out->push_back('}');  // EMPTY_DICT
      if (!v.dict.empty()) {
        out->push_back('(');
        for (const auto& kv : v.dict) {
          PickleValue(out, PvStr(kv.first));
          PickleValue(out, kv.second);
        }
        out->push_back('u');  // SETITEMS
      }
      break;
    }
  }
}

}  // namespace

std::string PickleDict(const std::map<std::string, PyVal>& d) {
  std::string out;
  out.push_back('\x80');  // PROTO
  out.push_back(3);
  PyVal v;
  v.kind = PyVal::Kind::Dict;
  v.dict = d;
  PickleValue(&out, v);
  out.push_back('.');  // STOP
  return out;
}

// -------------------------------------------------------------- unpickler
namespace {

class Reader {
 public:
  explicit Reader(const std::string& d) : d_(d) {}
  uint8_t u8() {
    Need(1);
    return uint8_t(d_[pos_++]);
  }
  uint32_t le32() {
    Need(4);
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) v |= uint32_t(uint8_t(d_[pos_ + i])) << (8 * i);
    pos_ += 4;
    return v;
  }
  uint64_t le64() {
    Need(8);
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v |= uint64_t(uint8_t(d_[pos_ + i])) << (8 * i);
    pos_ += 8;
    return v;
  }
  uint64_t be64() {
    Need(8);
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | uint8_t(d_[pos_ + i]);
    pos_ += 8;
    return v;
  }
  std::string bytes(size_t n) {
    Need(n);
    std::string s = d_.substr(pos_, n);
    pos_ += n;
    return s;
  }

 private:
  void Need(size_t n) {
    // overflow-safe: pos_ + n can wrap for a hostile BINBYTES8 length,
    // which would pass the naive check and desync the parse
    if (pos_ > d_.size() || n > d_.size() - pos_)
      throw ClientError("pickle: truncated stream");
  }
  const std::string& d_;
  size_t pos_ = 0;
};

constexpr int kMark = -1;  // sentinel index on the mark stack

}  // namespace

PyVal Unpickle(const std::string& data) {
  Reader r(data);
  std::vector<PyVal> stack;
  std::vector<size_t> marks;
  // memo entries are COPIES, but large bytes payloads sit behind a
  // shared_ptr inside PyVal, so protocol-5's MEMOIZE-every-bytes habit
  // costs pointer copies, not buffer copies — and duplicate-id fetches
  // (BINGET of a repeated payload) resolve correctly
  std::vector<PyVal> memo;

  auto memoPut = [&](size_t idx, const PyVal& v) {
    if (memo.size() <= idx) memo.resize(idx + 1);
    memo[idx] = v;
  };
  auto memoGet = [&](size_t idx) -> const PyVal& {
    if (idx >= memo.size()) throw ClientError("pickle: BINGET range");
    return memo[idx];
  };

  auto pop = [&]() {
    if (stack.empty()) throw ClientError("pickle: stack underflow");
    PyVal v = std::move(stack.back());
    stack.pop_back();
    return v;
  };
  auto popToMark = [&]() {
    if (marks.empty()) throw ClientError("pickle: no mark");
    size_t m = marks.back();
    marks.pop_back();
    std::vector<PyVal> items(stack.begin() + m, stack.end());
    stack.resize(m);
    return items;
  };

  for (;;) {
    uint8_t op = r.u8();
    switch (op) {
      case 0x80:  // PROTO
        r.u8();
        break;
      case 0x95:  // FRAME (8-byte length; framing only)
        r.le64();
        break;
      case '.':  // STOP
        if (stack.size() != 1) throw ClientError("pickle: bad final stack");
        return stack[0];
      case 'N':
        stack.push_back(PvNone());
        break;
      case 0x88:
        stack.push_back(PvBool(true));
        break;
      case 0x89:
        stack.push_back(PvBool(false));
        break;
      case 'K':  // BININT1
        stack.push_back(PvInt(r.u8()));
        break;
      case 'M': {  // BININT2 (LE; sequence the reads — '|' operand
                   // evaluation order is unspecified in C++17)
        uint32_t lo = r.u8();
        uint32_t hi = r.u8();
        stack.push_back(PvInt(lo | (hi << 8)));
        break;
      }
      case 'J':  // BININT (signed LE32)
        stack.push_back(PvInt(int32_t(r.le32())));
        break;
      case 0x8a: {  // LONG1 (LE two's complement)
        uint8_t n = r.u8();
        if (n > 8) throw ClientError("pickle: LONG1 too wide");
        std::string raw = r.bytes(n);
        uint64_t u = 0;  // unsigned accumulation: signed << is UB-prone
        for (int i = int(n) - 1; i >= 0; i--)
          u = (u << 8) | uint8_t(raw[size_t(i)]);
        if (n && n < 8 && (uint8_t(raw[n - 1]) & 0x80))
          u -= uint64_t(1) << (8 * n);  // sign-extend; n==8 is already
                                        // the full two's complement
        stack.push_back(PvInt(int64_t(u)));
        break;
      }
      case 'G': {  // BINFLOAT (BE double)
        uint64_t bits = r.be64();
        double f;
        std::memcpy(&f, &bits, 8);
        stack.push_back(PvFloat(f));
        break;
      }
      case 0x8c:  // SHORT_BINUNICODE
        stack.push_back(PvStr(r.bytes(r.u8())));
        break;
      case 'X':  // BINUNICODE
        stack.push_back(PvStr(r.bytes(r.le32())));
        break;
      case 'C':  // SHORT_BINBYTES
        stack.push_back(PvBytes(r.bytes(r.u8())));
        break;
      case 'B':  // BINBYTES
        stack.push_back(PvBytes(r.bytes(r.le32())));
        break;
      case 0x8e:  // BINBYTES8
        stack.push_back(PvBytes(r.bytes(size_t(r.le64()))));
        break;
      case '}': {  // EMPTY_DICT
        PyVal v;
        v.kind = PyVal::Kind::Dict;
        stack.push_back(std::move(v));
        break;
      }
      case ']': {  // EMPTY_LIST
        PyVal v;
        v.kind = PyVal::Kind::List;
        stack.push_back(std::move(v));
        break;
      }
      case ')': {  // EMPTY_TUPLE (tuples decode as lists)
        PyVal v;
        v.kind = PyVal::Kind::List;
        stack.push_back(std::move(v));
        break;
      }
      case '(':  // MARK
        marks.push_back(stack.size());
        break;
      case 'a': {  // APPEND
        PyVal item = pop();
        if (stack.empty() || stack.back().kind != PyVal::Kind::List)
          throw ClientError("pickle: APPEND to non-list");
        stack.back().list.push_back(std::move(item));
        break;
      }
      case 'e': {  // APPENDS
        auto items = popToMark();
        if (stack.empty() || stack.back().kind != PyVal::Kind::List)
          throw ClientError("pickle: APPENDS to non-list");
        for (auto& it : items) stack.back().list.push_back(std::move(it));
        break;
      }
      case 's': {  // SETITEM
        PyVal v = pop();
        PyVal k = pop();
        if (stack.empty() || stack.back().kind != PyVal::Kind::Dict)
          throw ClientError("pickle: SETITEM to non-dict");
        if (k.kind != PyVal::Kind::Str)
          throw ClientError("pickle: non-str dict key");
        stack.back().dict[k.s] = std::move(v);
        break;
      }
      case 'u': {  // SETITEMS
        auto items = popToMark();
        if (items.size() % 2)
          throw ClientError("pickle: odd SETITEMS count");
        if (stack.empty() || stack.back().kind != PyVal::Kind::Dict)
          throw ClientError("pickle: SETITEMS to non-dict");
        for (size_t i = 0; i < items.size(); i += 2) {
          if (items[i].kind != PyVal::Kind::Str)
            throw ClientError("pickle: non-str dict key");
          stack.back().dict[items[i].s] = std::move(items[i + 1]);
        }
        break;
      }
      case 0x85: {  // TUPLE1
        PyVal a = pop();
        stack.push_back(PvList({std::move(a)}));
        break;
      }
      case 0x86: {  // TUPLE2
        PyVal b = pop(), a = pop();
        stack.push_back(PvList({std::move(a), std::move(b)}));
        break;
      }
      case 0x87: {  // TUPLE3
        PyVal c = pop(), b = pop(), a = pop();
        stack.push_back(PvList({std::move(a), std::move(b), std::move(c)}));
        break;
      }
      case 't': {  // TUPLE
        auto items = popToMark();
        stack.push_back(PvList(std::move(items)));
        break;
      }
      case 0x94:  // MEMOIZE
        if (stack.empty()) throw ClientError("pickle: MEMOIZE empty");
        memoPut(memo.size(), stack.back());
        break;
      case 'q':  // BINPUT
        if (stack.empty()) throw ClientError("pickle: BINPUT empty");
        memoPut(r.u8(), stack.back());
        break;
      case 'r':  // LONG_BINPUT
        if (stack.empty()) throw ClientError("pickle: LONG_BINPUT empty");
        memoPut(r.le32(), stack.back());
        break;
      case 'h':  // BINGET
        stack.push_back(memoGet(r.u8()));
        break;
      case 'j':  // LONG_BINGET
        stack.push_back(memoGet(r.le32()));
        break;
      default:
        throw ClientError("pickle: unsupported opcode " +
                          std::to_string(int(op)) +
                          " (reply outside the supported subset)");
    }
  }
}

// ---------------------------------------------------------------- client
static void WriteAll(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t w = ::write(fd, p, n);
    if (w <= 0) throw ClientError("socket write failed");
    p += w;
    n -= size_t(w);
  }
}

static void ReadAll(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) throw ClientError("socket read failed (connection lost?)");
    p += r;
    n -= size_t(r);
  }
}

void Client::SendFrame(const std::string& payload) {
  if (payload.size() > 0x7fffffff)
    throw ClientError("frame too large");  // requests never approach this
  uint8_t hdr[4];
  uint32_t n = uint32_t(payload.size());
  for (int i = 0; i < 4; i++) hdr[i] = uint8_t(n >> (24 - 8 * i));
  WriteAll(fd_, hdr, 4);
  WriteAll(fd_, payload.data(), payload.size());
}

std::string Client::RecvFrame(size_t max) {
  uint8_t hdr[4];
  ReadAll(fd_, hdr, 4);
  int32_t n32 = int32_t((uint32_t(hdr[0]) << 24) | (uint32_t(hdr[1]) << 16) |
                        (uint32_t(hdr[2]) << 8) | uint32_t(hdr[3]));
  uint64_t n;
  if (n32 == -1) {  // extended 8-byte length
    uint8_t ext[8];
    ReadAll(fd_, ext, 8);
    n = 0;
    for (int i = 0; i < 8; i++) n = (n << 8) | ext[i];
  } else if (n32 < 0) {
    throw ClientError("bad frame length");
  } else {
    n = uint64_t(n32);
  }
  if (n > max) throw ClientError("frame exceeds limit");
  std::string out(size_t(n), '\0');
  ReadAll(fd_, out.data(), size_t(n));
  return out;
}

void Client::Handshake(const std::string& authkey) {
  static const std::string kChallenge = "#CHALLENGE#";
  static const std::string kWelcome = "#WELCOME#";

  // 1. answer the server's challenge
  std::string msg = RecvFrame(256);
  if (msg.rfind(kChallenge, 0) != 0)
    throw ClientError("auth: expected challenge");
  msg = msg.substr(kChallenge.size());
  // modern messages are b"{digest}<payload>"; the MAC covers the WHOLE
  // message including the prefix
  if (msg.rfind("{sha256}", 0) != 0 && msg[0] == '{')
    throw ClientError("auth: server requested an unsupported digest");
  std::string mac = HmacSha256(authkey, msg);
  SendFrame("{sha256}" + mac);
  if (RecvFrame(256) != kWelcome) throw ClientError("auth: digest rejected");

  // 2. deliver our own challenge (mutual auth)
  std::random_device rd;
  std::string payload = "{sha256}";
  for (int i = 0; i < 32; i++) payload.push_back(char(rd() & 0xff));
  SendFrame(kChallenge + payload);
  std::string response = RecvFrame(256);
  if (response.rfind("{sha256}", 0) == 0)
    response = response.substr(std::string("{sha256}").size());
  if (response != HmacSha256(authkey, payload)) {
    SendFrame("#FAILURE#");
    throw ClientError("auth: server failed our challenge");
  }
  SendFrame(kWelcome);
}

Client::Client(const std::string& host, int port, const std::string& authkey) {
  struct addrinfo hints {};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  if (getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints, &res) ||
      !res)
    throw ClientError("cannot resolve " + host);
  fd_ = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd_ < 0 || ::connect(fd_, res->ai_addr, res->ai_addrlen) != 0) {
    freeaddrinfo(res);
    if (fd_ >= 0) ::close(fd_);
    fd_ = -1;
    throw ClientError("cannot connect to " + host + ":" +
                      std::to_string(port));
  }
  freeaddrinfo(res);
  int one = 1;
  setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  try {
    Handshake(authkey);
    // version-checked ping (the server raises on wire-protocol mismatch)
    std::map<std::string, PyVal> ping;
    ping["type"] = PvStr("ping");
    // ray_memory_management_tpu_torch.config.WIRE_PROTOCOL_VERSION: v2
    // changed only the transfer plane's range requests, none of the
    // thin-client verbs this client speaks
    ping["proto"] = PvInt(2);
    Request(std::move(ping));
  } catch (...) {
    // the destructor never runs for a partially constructed object:
    // close here or every failed connect leaks an fd
    ::close(fd_);
    fd_ = -1;
    throw;
  }
}

Client::~Client() { Close(); }

void Client::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

static std::string ScrapePrintable(const std::string& blob) {
  // the error field is a serialized Python exception; surface the
  // readable runs (type name, message) without a full unpickler
  std::string out;
  std::string run;
  for (char c : blob) {
    if (c >= 0x20 && c < 0x7f) {
      run.push_back(c);
    } else {
      if (run.size() >= 5) {
        if (!out.empty()) out += " | ";
        out += run;
      }
      run.clear();
    }
  }
  if (run.size() >= 5) {
    if (!out.empty()) out += " | ";
    out += run;
  }
  return out.empty() ? "<opaque server exception>" : out;
}

PyVal Client::Request(std::map<std::string, PyVal> msg) {
  if (fd_ < 0) throw ClientError("client is closed");
  int64_t req_id = ++req_counter_;
  msg["req_id"] = PvInt(req_id);
  SendFrame(PickleDict(msg));
  PyVal reply = Unpickle(RecvFrame());
  if (reply.kind != PyVal::Kind::Dict)
    throw ClientError("reply is not a dict");
  auto it = reply.dict.find("req_id");
  if (it == reply.dict.end() || it->second.i != req_id)
    throw ClientError("reply req_id mismatch");
  auto err = reply.dict.find("error");
  if (err != reply.dict.end() && !err->second.is_none()) {
    // bytes() dereferences the out-of-line 'big' storage that payloads
    // over 4 KiB land in; .s would be empty for those and report every
    // large serialized exception as opaque
    const PyVal& ev = err->second;
    const std::string& blob =
        (ev.kind == PyVal::Kind::Bytes || ev.kind == PyVal::Kind::Str)
            ? ev.bytes()
            : ev.s;
    throw ClientError("server error: " + ScrapePrintable(blob));
  }
  return reply;
}

std::string Client::Put(const std::string& data) {
  std::map<std::string, PyVal> msg;
  msg["type"] = PvStr("put_bytes");
  msg["data"] = PvBytes(data);
  return Request(std::move(msg)).dict.at("object_id").bytes();
}

std::vector<std::string> Client::Get(const std::vector<std::string>& ids,
                                     double timeout_s) {
  std::map<std::string, PyVal> msg;
  msg["type"] = PvStr("get_bytes");
  std::vector<PyVal> oids;
  for (const auto& id : ids) oids.push_back(PvBytes(id));
  msg["oids"] = PvList(std::move(oids));
  msg["timeout"] = timeout_s < 0 ? PvNone() : PvFloat(timeout_s);
  PyVal reply = Request(std::move(msg));
  std::vector<std::string> out;
  for (const auto& v : reply.dict.at("values").list) out.push_back(v.bytes());
  return out;
}

std::vector<std::string> Client::Call(const std::string& name,
                                      const std::vector<std::string>& args,
                                      int num_cpus) {
  std::map<std::string, PyVal> msg;
  msg["type"] = PvStr("call_named");
  msg["name"] = PvStr(name);
  std::vector<PyVal> a;
  for (const auto& arg : args) a.push_back(PvBytes(arg));
  msg["args"] = PvList(std::move(a));
  if (num_cpus >= 0) {
    PyVal opts;
    opts.kind = PyVal::Kind::Dict;
    opts.dict["num_cpus"] = PvInt(num_cpus);
    msg["opts"] = std::move(opts);
  }
  PyVal reply = Request(std::move(msg));
  std::vector<std::string> out;
  for (const auto& v : reply.dict.at("return_ids").list)
    out.push_back(v.bytes());
  return out;
}

std::pair<std::vector<std::string>, std::vector<std::string>> Client::Wait(
    const std::vector<std::string>& ids, int num_returns, double timeout_s) {
  std::map<std::string, PyVal> msg;
  msg["type"] = PvStr("wait");
  std::vector<PyVal> oids;
  for (const auto& id : ids) oids.push_back(PvBytes(id));
  msg["oids"] = PvList(std::move(oids));
  msg["num_returns"] = PvInt(num_returns);
  msg["timeout"] = timeout_s < 0 ? PvNone() : PvFloat(timeout_s);
  PyVal reply = Request(std::move(msg));
  std::pair<std::vector<std::string>, std::vector<std::string>> out;
  for (const auto& v : reply.dict.at("ready").list)
    out.first.push_back(v.bytes());
  for (const auto& v : reply.dict.at("not_ready").list)
    out.second.push_back(v.bytes());
  return out;
}

void Client::Free(const std::vector<std::string>& ids) {
  std::map<std::string, PyVal> msg;
  msg["type"] = PvStr("free_refs");
  std::vector<PyVal> oids;
  for (const auto& id : ids) oids.push_back(PvBytes(id));
  msg["oids"] = PvList(std::move(oids));
  Request(std::move(msg));
}

std::vector<std::string> Client::ListFunctions() {
  std::map<std::string, PyVal> msg;
  msg["type"] = PvStr("list_named");
  PyVal reply = Request(std::move(msg));
  std::vector<std::string> out;
  for (const auto& v : reply.dict.at("names").list) out.push_back(v.s);
  return out;
}

std::map<std::string, double> Client::ClusterResources() {
  std::map<std::string, PyVal> msg;
  msg["type"] = PvStr("cluster_resources");
  PyVal reply = Request(std::move(msg));
  std::map<std::string, double> out;
  for (const auto& kv : reply.dict.at("resources").dict)
    out[kv.first] = kv.second.kind == PyVal::Kind::Int
                        ? double(kv.second.i)
                        : kv.second.f;
  return out;
}

PyVal Client::Rpc(std::map<std::string, PyVal> msg) {
  return Request(std::move(msg));
}

// ------------------------------------------------------------- Executor

Executor::Executor(const std::string& host, int port,
                   const std::string& authkey)
    : client_(host, port, authkey) {}

void Executor::Register(const std::string& name, Fn fn) {
  fns_[name] = std::move(fn);
}

void Executor::Start() {
  if (started_) return;
  std::vector<PyVal> names;
  for (const auto& kv : fns_) names.push_back(PvStr(kv.first));
  std::map<std::string, PyVal> msg;
  msg["type"] = PvStr("register_cpp_executor");
  msg["functions"] = PvList(std::move(names));
  PyVal reply = client_.Rpc(std::move(msg));
  ex_id_ = reply.dict.at("executor_id").bytes();
  started_ = true;
}

bool Executor::ServeOne(double poll_timeout_s) {
  if (!started_) Start();
  std::map<std::string, PyVal> poll;
  poll["type"] = PvStr("next_cpp_task");
  poll["executor_id"] = PvBytes(ex_id_);
  poll["timeout"] = PvFloat(poll_timeout_s);
  PyVal reply = client_.Rpc(std::move(poll));
  const PyVal& task = reply.dict.at("task");
  if (task.is_none()) return false;

  const std::string& name = task.dict.at("name").s;
  std::vector<std::string> args;
  for (const auto& a : task.dict.at("args").list) args.push_back(a.bytes());

  std::map<std::string, PyVal> done;
  done["type"] = PvStr("cpp_task_done");
  done["executor_id"] = PvBytes(ex_id_);
  done["task_id"] = PvStr(task.dict.at("task_id").s);
  auto it = fns_.find(name);
  if (it == fns_.end()) {
    done["err"] = PvStr("executor has no function '" + name + "'");
  } else {
    try {
      std::vector<std::string> results = it->second(args);
      std::vector<PyVal> out;
      out.reserve(results.size());
      for (auto& r : results) out.push_back(PvBytes(std::move(r)));
      done["results"] = PvList(std::move(out));
    } catch (const std::exception& e) {
      done["err"] = PvStr(std::string("C++ exception: ") + e.what());
    }
  }
  client_.Rpc(std::move(done));
  return true;
}

void Executor::ServeForever() {
  for (;;) ServeOne(5.0);  // connection loss -> ClientError unwinds out
}

}  // namespace rmt
