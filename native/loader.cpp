// Threaded dense-binary loader: read a row-major float64 file and convert
// to float32 (or copy float64) in parallel chunks.
//
// Replaces the reference's collective MPI-IO read
// (V.read_dense_from_file(fh), test_ALS.cxx:302) for the single-host
// case: the 2.7 GB f64 coil-100 file converts to f32 at memory bandwidth
// instead of a single-threaded numpy astype pass.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Read `count` float64 values starting at byte `offset` from `path` into
// float32 `out`. Returns 0 on success, nonzero on error.
int load_f64_as_f32(const char* path, int64_t offset, int64_t count,
                    float* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 4;
  int err = 0;
  int64_t chunk = (count + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = (int64_t)t * chunk;
    int64_t hi = lo + chunk < count ? lo + chunk : count;
    if (lo >= hi) break;
    ts.emplace_back([&, lo, hi]() {
      FILE* f = fopen(path, "rb");
      if (!f) { err = 1; return; }
      if (fseeko(f, offset + lo * 8, SEEK_SET) != 0) { err = 2; fclose(f); return; }
      const int64_t BUF = 1 << 16;
      std::vector<double> buf(BUF);
      int64_t pos = lo;
      while (pos < hi) {
        int64_t n = hi - pos < BUF ? hi - pos : BUF;
        size_t got = fread(buf.data(), 8, (size_t)n, f);
        if ((int64_t)got != n) { err = 3; break; }
        for (int64_t i = 0; i < n; i++) out[pos + i] = (float)buf[i];
        pos += n;
      }
      fclose(f);
    });
  }
  for (auto& th : ts) th.join();
  return err;
}

// Same but keep float64.
int load_f64(const char* path, int64_t offset, int64_t count, double* out,
             int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 4;
  int err = 0;
  int64_t chunk = (count + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = (int64_t)t * chunk;
    int64_t hi = lo + chunk < count ? lo + chunk : count;
    if (lo >= hi) break;
    ts.emplace_back([&, lo, hi]() {
      FILE* f = fopen(path, "rb");
      if (!f) { err = 1; return; }
      if (fseeko(f, offset + lo * 8, SEEK_SET) != 0) { err = 2; fclose(f); return; }
      size_t got = fread(out + lo, 8, (size_t)(hi - lo), f);
      if ((int64_t)got != hi - lo) err = 3;
      fclose(f);
    });
  }
  for (auto& th : ts) th.join();
  return err;
}

}  // extern "C"
