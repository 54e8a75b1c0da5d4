// Async frame writer: quantize + encode + disk write off the render thread
// (a copy of tracer/io/native/frame_writer.cpp).
//
// Native runtime component (C ABI for ctypes). The reference writes each
// frame synchronously inside the frame loop (ISaver::writeColor per pixel,
// src/camera.cu:52-153, 211-215); this writer runs the reference's exact
// quantize (divide by spp, sqrt gamma, clamp [0, 0.999], *256 — camera.cu:
// 54-73) and the file encode on a background thread with a bounded queue,
// so the accelerator starts the next frame while the previous one hits
// disk. Formats: 0 = binary (int32 w, int32 h, RGB bytes — BinarySaver,
// camera.cu:128-153), 1 = P3 text PPM (FileSaver, camera.cu:56-73).
//
// One change from tracer's copy: the quantize divides each raw sum by the
// divisor, as tracer_torch/io/image.py:quantize does, where tracer's copy
// multiplies by its float reciprocal; for a divisor that is not a power of
// two the two round a few values in a million to another byte.
//
// Built with g++ at first use by tracer_torch/io/native/__init__.py into
// build/tracer_torch/libtracer_io-<hash>.so.

#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
  std::vector<float> fb;  // H*W*3, raw sample sums
  int width = 0;
  int height = 0;
  float divisor = 1.0f;
  std::string path;
  int format = 0;  // 0 bin, 1 ppm
};

void quantize(const Job& job, std::vector<uint8_t>& out) {
  const size_t n = static_cast<size_t>(job.width) * job.height * 3;
  out.resize(n);
  for (size_t i = 0; i < n; ++i) {
    float c = job.fb[i] / job.divisor;
    float g = std::sqrt(c > 0.0f ? c : 0.0f);  // linearToGamma, camera.cu:54
    if (g < 0.0f) g = 0.0f;
    if (g > 0.999f) g = 0.999f;  // Interval(0.0, 0.999), camera.cu:64
    out[i] = static_cast<uint8_t>(256.0f * g);
  }
}

// returns true on success; on failure fills `err`
bool write_job(const Job& job, std::string& err) {
  std::vector<uint8_t> bytes;
  quantize(job, bytes);
  FILE* f = std::fopen(job.path.c_str(), job.format == 0 ? "wb" : "w");
  if (!f) {
    err = "cannot open " + job.path;
    return false;
  }
  bool ok = true;
  if (job.format == 0) {  // BinarySaver layout (camera.cu:139-142)
    int32_t wh[2] = {job.width, job.height};
    ok = std::fwrite(wh, sizeof(int32_t), 2, f) == 2 &&
         std::fwrite(bytes.data(), 1, bytes.size(), f) == bytes.size();
  } else {  // P3 PPM (camera.cu:58-73)
    ok = std::fprintf(f, "P3\n%d %d\n255\n", job.width, job.height) > 0;
    for (size_t i = 0; ok && i < bytes.size(); i += 3) {
      ok = std::fprintf(f, "%d %d %d\n", bytes[i], bytes[i + 1], bytes[i + 2]) > 0;
    }
  }
  ok = (std::fclose(f) == 0) && ok;
  if (!ok) err = "write failed for " + job.path;
  return ok;
}

struct Writer {
  static constexpr size_t kMaxQueue = 4;  // backpressure bound

  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable cv_done;
  bool stop = false;
  int in_flight = 0;
  int failures = 0;
  std::string first_error;
  std::thread worker;

  Writer() : worker([this] { run(); }) {}

  ~Writer() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv.notify_all();
    worker.join();
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [this] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
        ++in_flight;
      }
      cv_done.notify_all();  // queue slot freed (backpressure)
      std::string err;
      const bool ok = write_job(job, err);
      {
        std::lock_guard<std::mutex> lock(mu);
        --in_flight;
        if (!ok) {
          ++failures;
          if (first_error.empty()) first_error = err;
        }
      }
      cv_done.notify_all();
    }
  }

  void submit(Job&& job) {
    {
      std::unique_lock<std::mutex> lock(mu);
      // block the render thread when the writer falls behind, bounding
      // memory to kMaxQueue framebuffer copies
      cv_done.wait(lock, [this] { return queue.size() < kMaxQueue; });
      queue.push_back(std::move(job));
    }
    cv.notify_one();
  }

  int pending() {
    std::lock_guard<std::mutex> lock(mu);
    return static_cast<int>(queue.size()) + in_flight;
  }

  void wait() {
    std::unique_lock<std::mutex> lock(mu);
    cv_done.wait(lock, [this] { return queue.empty() && in_flight == 0; });
  }
};

}  // namespace

extern "C" {

void* tracer_writer_create() { return new Writer(); }

void tracer_writer_submit(void* w, const float* fb, int width, int height,
                          float divisor, const char* path, int format) {
  Job job;
  const size_t n = static_cast<size_t>(width) * height * 3;
  job.fb.assign(fb, fb + n);  // own copy: caller may reuse the buffer
  job.width = width;
  job.height = height;
  job.divisor = divisor;
  job.path = path;
  job.format = format;
  static_cast<Writer*>(w)->submit(std::move(job));
}

int tracer_writer_pending(void* w) { return static_cast<Writer*>(w)->pending(); }

void tracer_writer_wait(void* w) { static_cast<Writer*>(w)->wait(); }

// number of failed writes since creation; fills buf with the first error
int tracer_writer_failures(void* w, char* buf, int buf_len) {
  Writer* writer = static_cast<Writer*>(w);
  std::lock_guard<std::mutex> lock(writer->mu);
  if (buf && buf_len > 0) {
    std::snprintf(buf, buf_len, "%s", writer->first_error.c_str());
  }
  return writer->failures;
}

void tracer_writer_destroy(void* w) { delete static_cast<Writer*>(w); }

}  // extern "C"
