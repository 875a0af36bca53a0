// Threaded .npy batch loader with a bounded prefetch queue.
//
// Native-runtime replacement for the reference's torch DataLoader
// worker pool (data/__init__.py:113-117 num_threads) — the reference's
// only host-side "runtime" component besides the physics engines.
// Parses NPY v1/v2 headers (C-order float32/float64 arrays, little- or
// big-endian), reads payloads on a pool of worker threads, and hands
// fixed-order results to Python through a ctypes-friendly C ABI.
//
// Built by data/_native_build.py:
//   g++ -O2 -shared -fPIC -std=c++17 -o <lib>.so npy_loader.cpp -O3 -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Array {
  std::vector<float> data;
  std::vector<int64_t> shape;
  bool ok = false;
};

bool parse_npy(const std::string& path, Array* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char magic[6];
  f.read(magic, 6);
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  unsigned char ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    uint16_t h16;
    f.read(reinterpret_cast<char*>(&h16), 2);
    hlen = h16;
  } else {
    f.read(reinterpret_cast<char*>(&hlen), 4);
  }
  std::string header(hlen, '\0');
  f.read(header.data(), hlen);

  // dtype, either byte order (big-endian payloads are swapped)
  auto has = [&](const char* d) {
    return header.find(d) != std::string::npos;
  };
  bool big = has("'>f4'") || has("'>f8'");
  bool f32 = has("'<f4'") || has("'|f4'") || has("'>f4'");
  bool f64 = has("'<f8'") || has("'>f8'");
  if (!f32 && !f64) return false;
  if (header.find("'fortran_order': True") != std::string::npos)
    return false;

  // shape tuple
  auto sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  auto lp = header.find('(', sp);
  auto rp = header.find(')', lp);
  std::string shape_s = header.substr(lp + 1, rp - lp - 1);
  out->shape.clear();
  size_t pos = 0;
  while (pos < shape_s.size()) {
    while (pos < shape_s.size() &&
           (shape_s[pos] == ' ' || shape_s[pos] == ',')) pos++;
    if (pos >= shape_s.size()) break;
    size_t end;
    long v = std::stol(shape_s.substr(pos), &end);
    out->shape.push_back(v);
    pos += end;
  }
  int64_t n = 1;
  for (auto s : out->shape) n *= s;
  out->data.resize(n);
  if (f32) {
    f.read(reinterpret_cast<char*>(out->data.data()), n * 4);
    if (big) {
      auto* u = reinterpret_cast<uint32_t*>(out->data.data());
      for (int64_t i = 0; i < n; i++) u[i] = __builtin_bswap32(u[i]);
    }
  } else {
    std::vector<double> tmp(n);
    f.read(reinterpret_cast<char*>(tmp.data()), n * 8);
    if (big) {
      auto* u = reinterpret_cast<uint64_t*>(tmp.data());
      for (int64_t i = 0; i < n; i++) u[i] = __builtin_bswap64(u[i]);
    }
    for (int64_t i = 0; i < n; i++) out->data[i] = float(tmp[i]);
  }
  out->ok = static_cast<bool>(f);
  return out->ok;
}

struct Loader {
  std::vector<std::string> paths;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  // results delivered strictly in request order
  std::vector<Array> results;
  std::vector<char> done_flags;
  std::atomic<size_t> next_job{0};
  size_t next_out = 0;
  size_t capacity;
  std::atomic<bool> stop{false};

  Loader(std::vector<std::string> p, int n_threads, size_t cap)
      : paths(std::move(p)), capacity(cap) {
    results.resize(paths.size());
    done_flags.assign(paths.size(), 0);
    for (int i = 0; i < n_threads; i++)
      workers.emplace_back([this] { run(); });
  }

  void run() {
    while (!stop.load()) {
      size_t j = next_job.fetch_add(1);
      if (j >= paths.size()) return;
      // bounded prefetch: don't run too far ahead of the consumer
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] {
          return stop.load() || j < next_out + capacity;
        });
        if (stop.load()) return;
      }
      Array a;
      parse_npy(paths[j], &a);
      {
        std::lock_guard<std::mutex> lk(mu);
        results[j] = std::move(a);
        done_flags[j] = 1;
      }
      cv_pop.notify_all();
    }
  }

  // Blocks until item `next_out` is ready; returns it.
  Array take() {
    std::unique_lock<std::mutex> lk(mu);
    size_t j = next_out;
    cv_pop.wait(lk, [&] { return stop.load() || done_flags[j]; });
    Array a = std::move(results[j]);
    results[j] = Array{};
    next_out = j + 1;
    cv_push.notify_all();
    return a;
  }

  ~Loader() {
    stop.store(true);
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& w : workers) w.join();
  }
};

}  // namespace

extern "C" {

void* npy_loader_create(const char** paths, int n_paths, int n_threads,
                        int capacity) {
  std::vector<std::string> p(paths, paths + n_paths);
  return new Loader(std::move(p), n_threads, size_t(capacity));
}

// Returns ndim (>0) on success, -1 on failure/end. Caller provides
// shape buffer (max 8 dims) and a data buffer of max_elems floats;
// n_elems receives the element count (call with data=null & max=0 to
// query size first is NOT supported — use generous buffers or the
// two-phase peek below).
int npy_loader_next(void* handle, float* data, int64_t max_elems,
                    int64_t* shape_out, int64_t* n_elems) {
  auto* L = static_cast<Loader*>(handle);
  Array a = L->take();
  if (!a.ok) return -1;
  int64_t n = int64_t(a.data.size());
  *n_elems = n;
  if (n > max_elems) return -2;  // buffer too small
  std::memcpy(data, a.data.data(), n * sizeof(float));
  int nd = int(a.shape.size());
  for (int i = 0; i < nd && i < 8; i++) shape_out[i] = a.shape[i];
  return nd;
}

void npy_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
