// Native streaming ASR client library (C ABI).
//
// This framework's port of the reference's client packaging: the reference
// ships a C++ client behind a C ABI (`libclient.so`, ref:
// src/client/py-client/asr-client-api.h:10-24 TcpConnect/SendPack/
// SendLastPack/GetResult) consumed by a ctypes Python client
// (ref: src/client/py-client/client.py:14-60).  This is the same shape
// against this framework's wire protocol (serving/protocol.py — clean
// little-endian structs over TCP, ref semantics
// src/service2/net-data-package.h:252-755).
//
// Build: g++ -O2 -shared -fPIC -o libasrclient.so asr_client.cc

#include <arpa/inet.h>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <cstdio>
#include <string>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kMagicC2S = 0x43325331;  // "C2S1"
constexpr uint32_t kMagicS2C = 0x53324331;  // "S2C1"

// full-buffer IO loops (ref: ReadN/WriteN, src/util/io-funcs.h:69-71)
bool WriteN(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool ReadN(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

void PutU32(std::vector<uint8_t>* out, uint32_t v) {
  out->push_back(v & 0xff);
  out->push_back((v >> 8) & 0xff);
  out->push_back((v >> 16) & 0xff);
  out->push_back((v >> 24) & 0xff);
}

uint32_t GetU32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

extern "C" {

// ref: TcpConnect (asr-client-api.h:10)
int asr_tcp_connect(const char* ip, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, ip, &addr.sin_addr) != 1 ||
      ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// One C2S chunk (ref: SendPack / SendLastPack, asr-client-api.h:12-18).
// pcm: 16-bit little-endian samples; head/eos/lattice/nbest as in the
// C2S head (serving/protocol.py C2SPackage.HEAD "<IBBBBBBBBBBBII").
int asr_send_pack_ex(int fd, const char* pcm, int nbytes, int audio_head,
                     int eos, int nbest, int want_lattice, int want_align,
                     int want_score, int seq) {
  if (nbest < 0 || nbest > 63) return -1;
  std::vector<uint8_t> head;
  head.reserve(23);
  PutU32(&head, kMagicC2S);
  const uint8_t flags[11] = {
      /*dtype=SHORT*/ 0, /*bit*/ 16, /*sample_rate=K16*/ 0,
      /*audio_type=PCM*/ 0, static_cast<uint8_t>(audio_head != 0),
      static_cast<uint8_t>(want_lattice != 0),
      static_cast<uint8_t>(want_align != 0),
      static_cast<uint8_t>(want_score != 0),
      static_cast<uint8_t>(nbest), static_cast<uint8_t>(eos != 0),
      /*keep*/ 0};
  head.insert(head.end(), flags, flags + 11);
  PutU32(&head, static_cast<uint32_t>(seq));
  PutU32(&head, static_cast<uint32_t>(nbytes));
  if (!WriteN(fd, head.data(), head.size())) return -1;
  if (nbytes > 0 && !WriteN(fd, pcm, static_cast<size_t>(nbytes))) return -1;
  return 0;
}

int asr_send_pack(int fd, const char* pcm, int nbytes, int audio_head,
                  int eos, int nbest, int want_lattice, int seq) {
  return asr_send_pack_ex(fd, pcm, nbytes, audio_head, eos, nbest,
                          want_lattice, /*align=*/0, /*score=*/0, seq);
}

// Read one S2C reply; copies the 1-best text into text_out (NUL-terminated,
// truncated to text_cap-1) and stores the end flag (0/1/2).  When
// align_out is non-NULL and the reply carries the AlignTime payload
// (ref: net-data-package.h:210; parsed in the ref client at
// src/client/py-client/asr-client-api.cc:119-126), writes one
// "word\tbegin\tend\n" line per word.  Returns the number of n-best
// results, or -1 on error.  (ref: GetResult, asr-client-api.h:20-24)
int asr_get_result_align(int fd, char* text_out, int text_cap,
                         int* end_flag, char* align_out, int align_cap) {
  uint8_t lenbuf[4];
  if (!ReadN(fd, lenbuf, 4)) return -1;
  uint32_t n = GetU32(lenbuf);
  if (n < 15 || n > (64u << 20)) return -1;
  std::vector<uint8_t> body(n);
  if (!ReadN(fd, body.data(), n)) return -1;
  const uint8_t* p = body.data();
  if (GetU32(p) != kMagicS2C) return -1;
  if (end_flag) *end_flag = p[4];
  uint8_t has_ali = p[7];
  uint32_t nres = GetU32(p + 11);
  size_t off = 15;  // head: magic(4) + 7 flag bytes (incl. warn) + nres(4)
  if (text_out && text_cap > 0) text_out[0] = '\0';
  if (align_out && align_cap > 0) align_out[0] = '\0';
  for (uint32_t i = 0; i < nres; ++i) {
    if (off + 4 > n) return -1;
    uint32_t tl = GetU32(p + off);
    off += 4;
    if (off + tl + 8 + 4 > n) return -1;
    if (i == 0 && text_out && text_cap > 0) {
      uint32_t c = tl < static_cast<uint32_t>(text_cap - 1)
                       ? tl
                       : static_cast<uint32_t>(text_cap - 1);
      std::memcpy(text_out, p + off, c);
      text_out[c] = '\0';
    }
    off += tl + 8;  // text + graph/am scores
    uint32_t nw = GetU32(p + off);
    off += 4 + 4 * static_cast<size_t>(nw);
    if (off > n) return -1;
  }
  if (has_ali) {
    if (off + 4 > n) return -1;
    uint32_t na = GetU32(p + off);
    off += 4;
    std::string lines;
    for (uint32_t i = 0; i < na; ++i) {
      if (off + 4 > n) return -1;
      uint32_t wl = GetU32(p + off);
      off += 4;
      if (off + wl + 8 > n) return -1;
      std::string word(reinterpret_cast<const char*>(p + off), wl);
      off += wl;
      float be[2];
      std::memcpy(be, p + off, 8);
      off += 8;
      char buf[64];
      std::snprintf(buf, sizeof(buf), "\t%.3f\t%.3f\n", be[0], be[1]);
      lines += word;
      lines += buf;
    }
    if (align_out && align_cap > 0) {
      size_t c = lines.size() < static_cast<size_t>(align_cap - 1)
                     ? lines.size()
                     : static_cast<size_t>(align_cap - 1);
      std::memcpy(align_out, lines.data(), c);
      align_out[c] = '\0';
    }
  }
  return static_cast<int>(nres);
}

int asr_get_result(int fd, char* text_out, int text_cap, int* end_flag) {
  return asr_get_result_align(fd, text_out, text_cap, end_flag, NULL, 0);
}

void asr_close(int fd) { ::close(fd); }

}  // extern "C"
