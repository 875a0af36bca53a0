// Native Seismic-Unix trace reader.
//
// The reference's observed elastic data is DENISE .su shot files
// (su/seis_{x,y}.su.shot<k>, networks.py:7669-7692): a sequence of
// traces, each a 240-byte SEG-Y trace header (ns = uint16 at byte
// 114, dt in microseconds = uint16 at byte 116) followed by ns
// float32 samples.  This reader probes the byte order (every trace
// header must agree on ns and the trace size must tile the file),
// then parses + byte-swaps all traces into a caller-provided
// [ntraces, ns] float32 buffer.  Python binds via ctypes
// (data/native_loader.py pattern); numpy remains the fallback.
//
// Built by data/_native_build.py:
//   g++ -O2 -shared -fPIC -std=c++17 -o <lib>.so su_reader.cpp
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kHdrBytes = 240;
constexpr int kNsOffset = 114;
constexpr int kDtOffset = 116;

uint16_t rd_u16(const unsigned char* p, bool big) {
  return big ? static_cast<uint16_t>((p[0] << 8) | p[1])
             : static_cast<uint16_t>((p[1] << 8) | p[0]);
}

bool load_file(const char* path, std::vector<unsigned char>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < kHdrBytes + 4) {
    std::fclose(f);
    return false;
  }
  buf->resize(static_cast<size_t>(size));
  size_t got = std::fread(buf->data(), 1, buf->size(), f);
  std::fclose(f);
  return got == buf->size();
}

// Checks one byte order; returns true and fills ntr/ns/dt if every
// trace header agrees on ns and traces tile the file exactly.
bool try_order(const std::vector<unsigned char>& raw, bool big,
               int64_t* ntr, int64_t* ns, int64_t* dt_us) {
  uint16_t n0 = rd_u16(raw.data() + kNsOffset, big);
  if (n0 == 0) return false;
  size_t tr_bytes = kHdrBytes + 4ull * n0;
  if (raw.size() % tr_bytes) return false;
  size_t count = raw.size() / tr_bytes;
  for (size_t t = 1; t < count; ++t) {
    if (rd_u16(raw.data() + t * tr_bytes + kNsOffset, big) != n0)
      return false;
  }
  *ntr = static_cast<int64_t>(count);
  *ns = n0;
  *dt_us = rd_u16(raw.data() + kDtOffset, big);
  return true;
}

bool host_is_big() {
  const uint16_t one = 1;
  return *reinterpret_cast<const unsigned char*>(&one) == 0;
}

}  // namespace

extern "C" {

// Single-call parse: reads the file ONCE, probes the byte order,
// and returns a malloc'd host-order float32 buffer [*ntr * *ns]
// (caller releases with su_free).  On failure returns nullptr with
// *rc set: -1 unreadable file, -2 no consistent byte order,
// -4 allocation failure.
float* su_parse(const char* path, int64_t* ntr, int64_t* ns,
                int64_t* dt_us, int* rc) {
  std::vector<unsigned char> raw;
  if (!load_file(path, &raw)) {
    *rc = -1;
    return nullptr;
  }
  bool big;
  if (try_order(raw, /*big=*/false, ntr, ns, dt_us)) {
    big = false;
  } else if (try_order(raw, /*big=*/true, ntr, ns, dt_us)) {
    big = true;
  } else {
    *rc = -2;
    return nullptr;
  }
  size_t tr_bytes = kHdrBytes + 4ull * static_cast<size_t>(*ns);
  float* out = static_cast<float*>(
      std::malloc(sizeof(float) * static_cast<size_t>(*ntr) *
                  static_cast<size_t>(*ns)));
  if (!out) {
    *rc = -4;
    return nullptr;
  }
  const bool swap = big != host_is_big();
  for (int64_t t = 0; t < *ntr; ++t) {
    const unsigned char* src = raw.data() + t * tr_bytes + kHdrBytes;
    unsigned char* dst =
        reinterpret_cast<unsigned char*>(out + t * (*ns));
    if (!swap) {
      std::memcpy(dst, src, 4ull * static_cast<size_t>(*ns));
    } else {
      for (int64_t s = 0; s < *ns; ++s) {
        dst[4 * s + 0] = src[4 * s + 3];
        dst[4 * s + 1] = src[4 * s + 2];
        dst[4 * s + 2] = src[4 * s + 1];
        dst[4 * s + 3] = src[4 * s + 0];
      }
    }
  }
  *rc = 0;
  return out;
}

void su_free(float* p) { std::free(p); }

}  // extern "C"
