// framepipe — native video IO of depth_estimation_tpu_torch, the port's own
// copy of the JAX package's native/framepipe.cpp.
//
// The reference's hot loop decodes (FFmpeg via cv2.VideoCapture), infers and
// encodes (MJPG via cv2.VideoWriter) serially on one Python thread. This
// library moves both IO ends into C++ threads:
//
//   * a decoder thread fills a fixed ring of pre-allocated BGR frame slots
//     (producer), the Python consumer borrows slots zero-copy via ctypes —
//     no GIL on the decode path, no per-frame allocation;
//   * an encoder thread drains a bounded queue of frames into a
//     cv::VideoWriter — host encode overlaps device compute.
//
// A synthetic source reproduces runtime/video.py's SyntheticSource
// bit-for-bit so tests can diff native vs Python pipelines.
//
// OpenCV is optional: without its headers (or with FRAMEPIPE_NO_OPENCV
// defined) the library holds the ring, the decode thread and the synthetic
// source alone, fp_open_video and fw_open return null, and
// runtime/native.py's callers read and write files through Python IO.
// fp_has_opencv() says which build this is. runtime/native.py builds it
// with g++ at first use.

#if !defined(FRAMEPIPE_NO_OPENCV) && __has_include(<opencv2/videoio.hpp>)
#define FRAMEPIPE_OPENCV 1
#include <opencv2/videoio.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/core.hpp>
#else
#define FRAMEPIPE_OPENCV 0
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<unsigned char> data;
  bool full = false;
};

struct Source {
  virtual ~Source() = default;
  virtual bool read(unsigned char* dst) = 0;  // dst: h*w*3 BGR
  int width = 0, height = 0;
  double frame_count = 0;
};

#if FRAMEPIPE_OPENCV
struct VideoSource : Source {
  cv::VideoCapture cap;
  explicit VideoSource(const char* path) : cap(path) {
    cap.set(cv::CAP_PROP_BUFFERSIZE, 2);
    width = (int)cap.get(cv::CAP_PROP_FRAME_WIDTH);
    height = (int)cap.get(cv::CAP_PROP_FRAME_HEIGHT);
    frame_count = cap.get(cv::CAP_PROP_FRAME_COUNT);
  }
  bool read(unsigned char* dst) override {
    cv::Mat frame;
    if (!cap.read(frame) || frame.empty()) return false;
    // Normalize to the slot contract (height x width, CV_8UC3). convertTo
    // only changes element type, never dimensions or channel count, so each
    // mismatch gets its own fix — a frame whose decoded dimensions differ
    // from the capture metadata (bad container header, mid-stream resolution
    // change) must be resized or the memcpy below reads out of bounds.
    if (frame.channels() == 1) {
      cv::cvtColor(frame, frame, cv::COLOR_GRAY2BGR);
    } else if (frame.channels() == 4) {
      cv::cvtColor(frame, frame, cv::COLOR_BGRA2BGR);
    } else if (frame.channels() != 3) {
      return false;
    }
    if (frame.depth() != CV_8U) {
      cv::Mat tmp;
      frame.convertTo(tmp, CV_8UC3);
      frame = tmp;
    }
    if (frame.cols != width || frame.rows != height) {
      cv::Mat tmp;
      cv::resize(frame, tmp, cv::Size(width, height), 0, 0, cv::INTER_LINEAR);
      frame = tmp;
    }
    if (frame.isContinuous()) {
      std::memcpy(dst, frame.data, (size_t)width * height * 3);
    } else {
      for (int r = 0; r < height; ++r)
        std::memcpy(dst + (size_t)r * width * 3, frame.ptr(r), (size_t)width * 3);
    }
    return true;
  }
};
#endif  // FRAMEPIPE_OPENCV

// Bit-for-bit port of runtime/video.py SyntheticSource
struct SyntheticSource : Source {
  int n, i = 0;
  std::vector<unsigned char> base;
  SyntheticSource(int n_frames, int h, int w) : n(n_frames) {
    width = w;
    height = h;
    frame_count = n_frames;
    base.resize((size_t)h * w * 3);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        unsigned char b = (unsigned char)((x * 255) / (w > 1 ? w : 1));
        size_t o = ((size_t)y * w + x) * 3;
        base[o + 0] = b;
        base[o + 1] = (unsigned char)(b / 2);
        base[o + 2] = (unsigned char)(255 - b);
      }
  }
  bool read(unsigned char* dst) override {
    if (i >= n) return false;
    int t = i;
    int cx = width / 2 + (int)(0.25 * width * std::sin(t / 7.0));
    int cy = height / 2 + (int)(0.1 * height * std::cos(t / 5.0));
    int r = std::max(12, std::min(height, width) / 8);
    std::memcpy(dst, base.data(), base.size());
    long rr = (long)r * r;
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x) {
        long dx = x - cx, dy = y - cy;
        if (dx * dx + dy * dy < rr) {
          size_t o = ((size_t)y * width + x) * 3;
          dst[o + 0] = 230;
          dst[o + 1] = 220;
          dst[o + 2] = 210;
        }
      }
    ++i;
    return true;
  }
};

struct Pipe {
  std::unique_ptr<Source> src;
  std::vector<Slot> ring;
  size_t head = 0, tail = 0;  // producer writes head, consumer reads tail
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  bool eof = false, closed = false;
  std::thread worker;

  Pipe(std::unique_ptr<Source> s, int depth) : src(std::move(s)) {
    ring.resize(depth > 0 ? depth : 2);
    size_t bytes = (size_t)src->width * src->height * 3;
    for (auto& slot : ring) slot.data.resize(bytes);
    worker = std::thread([this] { pump(); });
  }

  void pump() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [this] { return closed || !ring[head % ring.size()].full; });
      if (closed) return;
      Slot& slot = ring[head % ring.size()];
      lk.unlock();
      bool ok = src->read(slot.data.data());
      lk.lock();
      if (!ok) {
        eof = true;
        cv_empty.notify_all();
        return;
      }
      slot.full = true;
      ++head;
      cv_empty.notify_all();
    }
  }

  // returns slot index, or -1 on EOF
  int acquire(unsigned char** data) {
    std::unique_lock<std::mutex> lk(mu);
    cv_empty.wait(lk, [this] {
      return closed || eof || ring[tail % ring.size()].full;
    });
    if (closed) return -1;
    Slot& slot = ring[tail % ring.size()];
    if (!slot.full) return -1;  // eof and drained
    *data = slot.data.data();
    return (int)(tail % ring.size());
  }

  void release(int idx) {
    std::lock_guard<std::mutex> lk(mu);
    ring[idx].full = false;
    ++tail;
    cv_full.notify_all();
  }

  ~Pipe() {
    {
      std::lock_guard<std::mutex> lk(mu);
      closed = true;
    }
    cv_full.notify_all();
    cv_empty.notify_all();
    if (worker.joinable()) worker.join();
  }
};

#if FRAMEPIPE_OPENCV
struct Writer {
  cv::VideoWriter out;
  std::deque<std::vector<unsigned char>> q;
  std::mutex mu;
  std::condition_variable cv_item, cv_space;
  bool closed = false;
  int w, h;
  size_t max_q = 8;
  std::thread worker;
  std::atomic<long> written{0};

  Writer(const char* path, int w_, int h_, double fps, const char* fourcc)
      : w(w_), h(h_) {
    int fcc = cv::VideoWriter::fourcc(fourcc[0], fourcc[1], fourcc[2], fourcc[3]);
    out.open(path, fcc, fps, cv::Size(w, h));
    worker = std::thread([this] { pump(); });
  }

  void pump() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_item.wait(lk, [this] { return closed || !q.empty(); });
      if (q.empty()) {
        if (closed) return;
        continue;
      }
      auto buf = std::move(q.front());
      q.pop_front();
      cv_space.notify_all();
      lk.unlock();
      cv::Mat m(h, w, CV_8UC3, buf.data());
      out.write(m);
      ++written;
    }
  }

  void write(const unsigned char* data) {
    std::unique_lock<std::mutex> lk(mu);
    cv_space.wait(lk, [this] { return closed || q.size() < max_q; });
    if (closed) return;
    q.emplace_back(data, data + (size_t)w * h * 3);
    cv_item.notify_all();
  }

  ~Writer() {
    {
      std::lock_guard<std::mutex> lk(mu);
      closed = true;
    }
    cv_item.notify_all();
    cv_space.notify_all();
    if (worker.joinable()) worker.join();
    out.release();
  }
};
#endif  // FRAMEPIPE_OPENCV

}  // namespace

extern "C" {

int fp_has_opencv() { return FRAMEPIPE_OPENCV; }

void* fp_open_video(const char* path, int ring_depth) {
#if FRAMEPIPE_OPENCV
  auto src = std::make_unique<VideoSource>(path);
  if (!src->cap.isOpened() || src->width <= 0 || src->height <= 0) return nullptr;
  return new Pipe(std::move(src), ring_depth);
#else
  (void)path;
  (void)ring_depth;
  return nullptr;
#endif
}

void* fp_open_synthetic(int n, int h, int w, int ring_depth) {
  return new Pipe(std::make_unique<SyntheticSource>(n, h, w), ring_depth);
}

int fp_width(void* p) { return ((Pipe*)p)->src->width; }
int fp_height(void* p) { return ((Pipe*)p)->src->height; }
double fp_frame_count(void* p) { return ((Pipe*)p)->src->frame_count; }

int fp_acquire(void* p, unsigned char** data) { return ((Pipe*)p)->acquire(data); }
void fp_release(void* p, int slot) { ((Pipe*)p)->release(slot); }
void fp_close(void* p) { delete (Pipe*)p; }

#if FRAMEPIPE_OPENCV
void* fw_open(const char* path, int w, int h, double fps, const char* fourcc) {
  auto* wr = new Writer(path, w, h, fps, fourcc);
  if (!wr->out.isOpened()) {
    delete wr;
    return nullptr;
  }
  return wr;
}
void fw_write(void* w, const unsigned char* data) { ((Writer*)w)->write(data); }
long fw_written(void* w) { return ((Writer*)w)->written.load(); }
void fw_close(void* w) { delete (Writer*)w; }
#else
// no writer without OpenCV: fw_open refuses, so no handle reaches the rest
void* fw_open(const char*, int, int, double, const char*) { return nullptr; }
void fw_write(void*, const unsigned char*) {}
long fw_written(void*) { return 0; }
void fw_close(void*) {}
#endif

}  // extern "C"
