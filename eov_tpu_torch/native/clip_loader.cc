// EOVC clip loader — native host runtime for the eov_tpu input pipeline.
//
// Capability parity: SURVEY.md §2b rows N3-N5. The reference leans on
// PIL/libjpeg + ffmpeg through a torch DataLoader's worker processes; the
// TPU-native runtime is this C++ loader: mmap'd EOVC shards, libjpeg frame
// decode on a pthread pool, and a double-buffered batch ring so host IO and
// decode overlap the TPU forward pass (BASELINE.json:5,11).
//
// C ABI (ctypes-friendly); all functions return 0 on success, negative on
// error unless documented otherwise.
//
// Build: make -C native   (links -ljpeg -lpthread)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <csetjmp>
#include <jpeglib.h>

namespace {

constexpr uint32_t kMagic = 0x43564F45u;  // "EOVC"
constexpr uint32_t kCodecRaw = 0;
constexpr uint32_t kCodecJpeg = 1;

#pragma pack(push, 1)
struct Header {
  uint32_t magic;
  uint32_t version;
  uint64_t n_clips;
  uint64_t index_off;
  uint32_t h, w;
  uint32_t codec;
};

struct ClipMetaFixed {
  char video_id[64];
  int32_t label;
  int32_t n_frames;
  uint64_t reserved;
};
#pragma pack(pop)

struct ClipMeta {
  ClipMetaFixed fixed;
  std::vector<uint64_t> frame_off;
  std::vector<uint32_t> frame_len;
};

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  Header hdr{};
  std::vector<ClipMeta> clips;
  // DCT-domain scaled decode (jpeg codec only, VERDICT r3 #3): libjpeg
  // decodes at 1/scale_denom directly from the DCT coefficients —
  // IDCT + color conversion run at the reduced resolution, cutting
  // decode cost ~denom^2 when storage resolution exceeds the pipeline's
  // scale_size. out_h/out_w are what decode produces and what
  // eovc_height/width report, so downstream buffer sizing Just Works.
  uint32_t scale_denom = 1;
  uint32_t out_h = 0, out_w = 0;
};

// ---- jpeg decode (libjpeg, longjmp error trap) ----------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode one JPEG payload to RGB u8 [th, tw, 3] at 1/scale_denom of the
// stored resolution (DCT-domain scaling; denom 1 = full size). If the
// decoded size differs from (th, tw), fails (shards are written
// size-normalized, and (th, tw) are precomputed with libjpeg's ceil rule).
int decode_jpeg(const uint8_t* data, size_t len, uint8_t* out, int th,
                int tw, unsigned scale_denom) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != th ||
      static_cast<int>(cinfo.output_width) != tw ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  const size_t stride = static_cast<size_t>(tw) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---- thread pool ----------------------------------------------------------

// Completion tracker: counted-down by workers, awaited via condvar (no
// busy-wait — spinning would steal cycles from decode threads on small
// hosts).
struct Completion {
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<int> err{0};
  int remaining = 0;

  void Arm(int n) { remaining = n; }
  void Done() {
    std::lock_guard<std::mutex> l(mu);
    if (--remaining == 0) cv.notify_all();
  }
  void Wait() {
    std::unique_lock<std::mutex> l(mu);
    cv.wait(l, [this] { return remaining == 0; });
  }
};

struct Task {
  const Store* store;
  int clip;
  const int32_t* frame_idx;  // [k]
  int k;
  uint8_t* out;  // [k, h, w, 3]
  Completion* done;
};

class Pool {
 public:
  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) {
      threads_.emplace_back([this] { Run(); });
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> l(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void Submit(Task t) {
    {
      std::lock_guard<std::mutex> l(mu_);
      q_.push(t);
    }
    cv_.notify_one();
  }

 private:
  void Run();
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<Task> q_;
  bool stop_ = false;
  std::vector<std::thread> threads_;
};

int load_clip_frames(const Store& s, int clip, const int32_t* frame_idx,
                     int k, uint8_t* out) {
  if (clip < 0 || static_cast<uint64_t>(clip) >= s.hdr.n_clips) return -4;
  const ClipMeta& m = s.clips[clip];
  const size_t frame_bytes =
      static_cast<size_t>(s.out_h) * s.out_w * 3;
  for (int i = 0; i < k; ++i) {
    int32_t f = frame_idx[i];
    if (f < 0 || f >= m.fixed.n_frames) return -5;
    const uint8_t* src = s.base + m.frame_off[f];
    uint8_t* dst = out + static_cast<size_t>(i) * frame_bytes;
    if (s.hdr.codec == kCodecRaw) {
      if (m.frame_len[f] != frame_bytes) return -6;
      std::memcpy(dst, src, frame_bytes);
    } else {
      int rc = decode_jpeg(src, m.frame_len[f], dst,
                           static_cast<int>(s.out_h),
                           static_cast<int>(s.out_w), s.scale_denom);
      if (rc != 0) return rc;
    }
  }
  return 0;
}

void Pool::Run() {
  for (;;) {
    Task t;
    {
      std::unique_lock<std::mutex> l(mu_);
      cv_.wait(l, [this] { return stop_ || !q_.empty(); });
      if (stop_ && q_.empty()) return;
      t = q_.front();
      q_.pop();
    }
    int rc = load_clip_frames(*t.store, t.clip, t.frame_idx, t.k, t.out);
    if (rc != 0) t.done->err.store(rc);
    t.done->Done();
  }
}

// ---- async batch ring -----------------------------------------------------

struct Batch {
  std::vector<int32_t> clips;
  std::vector<int32_t> frames;  // [b, k]
  int k = 0;
  uint8_t* out = nullptr;  // caller-owned destination
  Completion done;
};

struct Loader {
  Store store;
  std::unique_ptr<Pool> pool;
  int n_threads = 1;
  std::mutex mu;
  std::queue<std::unique_ptr<Batch>> inflight;
};

}  // namespace

extern "C" {

// Opens an EOVC file with DCT-scaled jpeg decode at 1/scale_denom
// (1, 2, 4 or 8; jpeg codec only — raw shards refuse any scaling).
// Returns handle or nullptr.
void* eovc_open_scaled(const char* path, int n_threads,
                       int32_t scale_denom) {
  auto* L = new Loader();
  L->store.fd = open(path, O_RDONLY);
  if (L->store.fd < 0) {
    delete L;
    return nullptr;
  }
  struct stat st;
  fstat(L->store.fd, &st);
  L->store.size = static_cast<size_t>(st.st_size);
  void* p = mmap(nullptr, L->store.size, PROT_READ, MAP_PRIVATE,
                 L->store.fd, 0);
  if (p == MAP_FAILED) {
    close(L->store.fd);
    delete L;
    return nullptr;
  }
  L->store.base = static_cast<const uint8_t*>(p);
  auto fail = [&]() -> void* {
    munmap(p, L->store.size);
    close(L->store.fd);
    delete L;
    return nullptr;
  };
  if (L->store.size < sizeof(Header)) return fail();
  std::memcpy(&L->store.hdr, L->store.base, sizeof(Header));
  if (L->store.hdr.magic != kMagic || L->store.hdr.version != 1)
    return fail();
  // Frame-dimension sanity: callers size their output buffers from h/w,
  // so a corrupt header must not pass open and turn a later load into a
  // multi-hundred-GB allocation bomb (found by the ASAN fuzz test). 2^26
  // pixels (~200 MB/frame RGB) is far beyond any real video frame.
  if (L->store.hdr.h == 0 || L->store.hdr.w == 0 ||
      static_cast<uint64_t>(L->store.hdr.h) * L->store.hdr.w > (1u << 26))
    return fail();
  // Parse index (bounds-checked against the mapped file: a truncated or
  // corrupt shard must fail open, not read out of bounds). Order matters:
  // index_off is validated BEFORE forming the index pointer, and n_clips
  // is bounded by the bytes the index region could possibly hold BEFORE
  // the resize — a corrupt n_clips (e.g. a flipped high byte) would
  // otherwise make vector::resize throw bad_alloc/length_error across the
  // extern "C" boundary and terminate the process (found by the r3
  // byte-flip fuzz test).
  if (L->store.hdr.index_off > L->store.size) return fail();
  if (L->store.hdr.n_clips >
      (L->store.size - L->store.hdr.index_off) / sizeof(ClipMetaFixed))
    return fail();
  const uint8_t* q = L->store.base + L->store.hdr.index_off;
  const uint8_t* end = L->store.base + L->store.size;
  L->store.clips.resize(L->store.hdr.n_clips);
  for (uint64_t i = 0; i < L->store.hdr.n_clips; ++i) {
    ClipMeta& m = L->store.clips[i];
    if (q + sizeof(ClipMetaFixed) > end) return fail();
    std::memcpy(&m.fixed, q, sizeof(ClipMetaFixed));
    q += sizeof(ClipMetaFixed);
    if (m.fixed.n_frames < 0 ||
        q + 12ull * m.fixed.n_frames > end)
      return fail();
    m.frame_off.resize(m.fixed.n_frames);
    std::memcpy(m.frame_off.data(), q, 8ull * m.fixed.n_frames);
    q += 8ull * m.fixed.n_frames;
    m.frame_len.resize(m.fixed.n_frames);
    std::memcpy(m.frame_len.data(), q, 4ull * m.fixed.n_frames);
    q += 4ull * m.fixed.n_frames;
    for (int32_t f = 0; f < m.fixed.n_frames; ++f) {
      // Overflow-safe form: off + len can wrap u64 on a corrupt/adversarial
      // shard (off near UINT64_MAX), which would defeat this exact check.
      if (m.frame_off[f] > L->store.size ||
          m.frame_len[f] > L->store.size - m.frame_off[f])
        return fail();
    }
  }
  if (scale_denom != 1 && scale_denom != 2 && scale_denom != 4 &&
      scale_denom != 8)
    return fail();
  if (scale_denom != 1 && L->store.hdr.codec != kCodecJpeg) return fail();
  L->store.scale_denom = static_cast<uint32_t>(scale_denom);
  // libjpeg's DCT-scaled output dimension rule: ceil(dim / denom).
  L->store.out_h = (L->store.hdr.h + L->store.scale_denom - 1) /
                   L->store.scale_denom;
  L->store.out_w = (L->store.hdr.w + L->store.scale_denom - 1) /
                   L->store.scale_denom;
  L->n_threads = n_threads > 0 ? n_threads : 1;
  L->pool.reset(new Pool(L->n_threads));
  return L;
}

// Back-compat entry point (full-resolution decode).
void* eovc_open(const char* path, int n_threads) {
  return eovc_open_scaled(path, n_threads, 1);
}

void eovc_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  if (!L) return;
  L->pool.reset();
  munmap(const_cast<uint8_t*>(L->store.base), L->store.size);
  close(L->store.fd);
  delete L;
}

int64_t eovc_n_clips(void* h) {
  return static_cast<int64_t>(static_cast<Loader*>(h)->store.hdr.n_clips);
}
int32_t eovc_height(void* h) {
  return static_cast<int32_t>(static_cast<Loader*>(h)->store.out_h);
}
int32_t eovc_width(void* h) {
  return static_cast<int32_t>(static_cast<Loader*>(h)->store.out_w);
}
int32_t eovc_codec(void* h) {
  return static_cast<int32_t>(static_cast<Loader*>(h)->store.hdr.codec);
}

int32_t eovc_clip_info(void* h, int64_t clip, char* video_id_out /*64*/,
                       int32_t* label_out, int32_t* n_frames_out) {
  auto* L = static_cast<Loader*>(h);
  if (clip < 0 || static_cast<uint64_t>(clip) >= L->store.hdr.n_clips)
    return -1;
  const ClipMetaFixed& f = L->store.clips[clip].fixed;
  std::memcpy(video_id_out, f.video_id, 64);
  *label_out = f.label;
  *n_frames_out = f.n_frames;
  return 0;
}

// Synchronous batch load: clips [b], frame indices [b, k] row-major,
// out [b, k, h, w, 3]. Parallelized over the pool. Returns 0 or first error.
int32_t eovc_load_batch(void* h, const int32_t* clips, int32_t b,
                        const int32_t* frames, int32_t k, uint8_t* out) {
  auto* L = static_cast<Loader*>(h);
  const size_t clip_bytes =
      static_cast<size_t>(k) * L->store.out_h * L->store.out_w * 3;
  Completion done;
  done.Arm(b);
  for (int32_t i = 0; i < b; ++i) {
    Task t{&L->store, clips[i], frames + static_cast<size_t>(i) * k, k,
           out + static_cast<size_t>(i) * clip_bytes, &done};
    L->pool->Submit(t);
  }
  done.Wait();
  return done.err.load();
}

// Async submit: enqueue a batch decode into caller buffer `out`; completion
// via eovc_wait (FIFO). Enables double/triple buffering against device
// compute from python without the GIL in the decode path.
int32_t eovc_submit(void* h, const int32_t* clips, int32_t b,
                    const int32_t* frames, int32_t k, uint8_t* out) {
  auto* L = static_cast<Loader*>(h);
  auto batch = std::make_unique<Batch>();
  batch->clips.assign(clips, clips + b);
  batch->frames.assign(frames, frames + static_cast<size_t>(b) * k);
  batch->k = k;
  batch->out = out;
  batch->done.Arm(b);
  const size_t clip_bytes =
      static_cast<size_t>(k) * L->store.out_h * L->store.out_w * 3;
  for (int32_t i = 0; i < b; ++i) {
    Task t{&L->store, batch->clips[i],
           batch->frames.data() + static_cast<size_t>(i) * k, k,
           out + static_cast<size_t>(i) * clip_bytes, &batch->done};
    L->pool->Submit(t);
  }
  std::lock_guard<std::mutex> l(L->mu);
  L->inflight.push(std::move(batch));
  return 0;
}

// Blocks until the oldest submitted batch completes; returns its status.
// Returns -100 if nothing is in flight.
int32_t eovc_wait(void* h) {
  auto* L = static_cast<Loader*>(h);
  std::unique_ptr<Batch> batch;
  {
    std::lock_guard<std::mutex> l(L->mu);
    if (L->inflight.empty()) return -100;
    batch = std::move(L->inflight.front());
    L->inflight.pop();
  }
  batch->done.Wait();
  return batch->done.err.load();
}

}  // extern "C"
