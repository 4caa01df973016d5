// Native flow dataloader: threaded read-ahead over a directory of .flo files
// (the port's own copy of voldor_tpu/native/flow_loader.cpp; built by
// voldor_tpu_torch/native/io.py with g++ into voldor_tpu_torch/_build/).
//
// Role: the reference keeps its loaders in Python threads with busy-wait
// caches (slam_py/voldor_slam.py:235-258); when the VO keeps the card busy
// the Python .flo parse + copy becomes a pipeline bubble. This loader owns
// the file IO on native threads and hands zero-parse float32 buffers to
// Python via ctypes (a plain C ABI: no pybind11 build step).
//
// C ABI:
//   void* vio_open(const char* dir, int n_prefetch, int n_threads,
//                  int range_lo, int range_hi);  // [lo, hi) or 0,0 = all
//   int   vio_count(void* h);
//   int   vio_dims(void* h, int* w, int* hgt);   // from the first file
//   int   vio_get(void* h, int idx, float* out, long cap);  // blocking
//   const char* vio_name(void* h, int idx);
//   void  vio_close(void* h);
//
// Thread model: a pool of reader threads prefetches files in index order,
// staying at most `n_prefetch` ahead of the newest consumer request;
// completed buffers park in a bounded cache keyed by index and are dropped
// once consumed (VO access is sequential with small lookback).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kFloMagic = 202021.25f;

struct FloBuffer {
  int w = 0, h = 0;
  std::vector<float> data;
};

bool read_flo(const std::string& path, FloBuffer* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  float magic = 0;
  int w = 0, h = 0;
  bool ok = std::fread(&magic, 4, 1, f) == 1 && magic == kFloMagic &&
            std::fread(&w, 4, 1, f) == 1 && std::fread(&h, 4, 1, f) == 1 &&
            w > 0 && h > 0 && w < 1 << 16 && h < 1 << 16;
  if (ok) {
    out->w = w;
    out->h = h;
    out->data.resize(static_cast<size_t>(w) * h * 2);
    ok = std::fread(out->data.data(), 4, out->data.size(), f) ==
         out->data.size();
  }
  std::fclose(f);
  return ok;
}

struct Loader {
  std::vector<std::string> files;
  int w = 0, h = 0;
  int n_prefetch = 16;

  std::mutex mu;
  std::condition_variable cv_ready;   // signals consumers: cache changed
  std::condition_variable cv_work;    // signals workers: frontier moved
  std::map<int, FloBuffer> cache;
  std::atomic<int> next_to_read{0};   // next index a worker should claim
  int frontier = 0;                   // newest consumer-requested index
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          return stop.load() ||
                 (next_to_read.load() < static_cast<int>(files.size()) &&
                  next_to_read.load() <= frontier + n_prefetch);
        });
        if (stop.load()) return;
        idx = next_to_read.fetch_add(1);
        if (idx >= static_cast<int>(files.size())) return;
      }
      FloBuffer buf;
      bool ok = read_flo(files[idx], &buf);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (!ok) buf = FloBuffer{};  // empty marks failure
        cache.emplace(idx, std::move(buf));
        // bound the cache: drop indices far behind the frontier
        while (cache.size() > static_cast<size_t>(2 * n_prefetch + 4)) {
          auto it = cache.begin();
          if (it->first >= frontier - 1) break;
          cache.erase(it);
        }
      }
      cv_ready.notify_all();
    }
  }

  // Blocking fetch; re-reads synchronously if the index was evicted.
  bool get(int idx, float* out, long cap) {
    if (idx < 0 || idx >= static_cast<int>(files.size())) return false;
    {
      std::lock_guard<std::mutex> lk(mu);
      if (idx > frontier) frontier = idx;
    }
    cv_work.notify_all();
    std::unique_lock<std::mutex> lk(mu);
    auto have = [&] { return cache.count(idx) > 0; };
    if (!have()) {
      // if workers already passed it (evicted), read synchronously
      if (next_to_read.load() > idx) {
        lk.unlock();
        FloBuffer buf;
        if (!read_flo(files[idx], &buf) ||
            static_cast<long>(buf.data.size()) > cap)
          return false;
        std::memcpy(out, buf.data.data(), buf.data.size() * 4);
        return true;
      }
      cv_ready.wait(lk, [&] { return have() || stop.load(); });
    }
    auto it = cache.find(idx);
    if (it == cache.end() || it->second.data.empty() ||
        static_cast<long>(it->second.data.size()) > cap)
      return false;
    std::memcpy(out, it->second.data.data(), it->second.data.size() * 4);
    return true;
  }
};

}  // namespace

extern "C" {

void* vio_open(const char* dir, int n_prefetch, int n_threads, int range_lo,
               int range_hi) {
  auto* L = new Loader();
  DIR* d = opendir(dir);
  if (!d) {
    delete L;
    return nullptr;
  }
  std::vector<std::string> names;
  while (dirent* e = readdir(d)) {
    std::string n = e->d_name;
    if (n.size() > 4 && n.substr(n.size() - 4) == ".flo") names.push_back(n);
  }
  closedir(d);
  std::sort(names.begin(), names.end());
  if (range_hi > range_lo) {
    int lo = std::max(0, range_lo);
    int hi = std::min<int>(names.size(), range_hi);
    names = std::vector<std::string>(names.begin() + lo, names.begin() + hi);
  }
  for (auto& n : names) L->files.push_back(std::string(dir) + "/" + n);
  if (L->files.empty()) {
    delete L;
    return nullptr;
  }
  FloBuffer first;
  if (!read_flo(L->files[0], &first)) {
    delete L;
    return nullptr;
  }
  L->w = first.w;
  L->h = first.h;
  L->n_prefetch = n_prefetch > 0 ? n_prefetch : 16;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->cache.emplace(0, std::move(first));
    L->next_to_read.store(1);
  }
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; i++) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

int vio_count(void* h) {
  return h ? static_cast<int>(static_cast<Loader*>(h)->files.size()) : 0;
}

int vio_dims(void* h, int* w, int* hgt) {
  if (!h) return 0;
  auto* L = static_cast<Loader*>(h);
  *w = L->w;
  *hgt = L->h;
  return 1;
}

int vio_get(void* h, int idx, float* out, long cap) {
  if (!h) return 0;
  return static_cast<Loader*>(h)->get(idx, out, cap) ? 1 : 0;
}

const char* vio_name(void* h, int idx) {
  if (!h) return nullptr;
  auto* L = static_cast<Loader*>(h);
  if (idx < 0 || idx >= static_cast<int>(L->files.size())) return nullptr;
  return L->files[idx].c_str();
}

void vio_close(void* h) {
  if (!h) return;
  auto* L = static_cast<Loader*>(h);
  {
    // under the mutex: a worker that has just found its wait predicate
    // false would otherwise miss the notify below and never wake
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_work.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
