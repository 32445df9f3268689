// Native threaded WAV batch loader (plain C ABI, ctypes-consumed).
//
// The host side of the input pipeline: reads N 16-bit PCM WAV files into
// one int16 (N, desired_samples) buffer with a worker pool — the role the
// reference delegates to TF's C++ decode_wav ops inside tf.data
// (multilingual_kws/embedding/input_data.py:40-46 + AUTOTUNE maps). Python
// (utils/wav.py) remains the semantic ground truth: channel 0 of the first
// `data` chunk, zero-pad or truncate to desired_samples. Non-16-bit files
// report status 2 and the Python caller falls back to utils/wav.py.
//
// Status codes per file: 0 ok, 1 io/open error, 2 unsupported format,
// 3 malformed RIFF.
//
// The port's own copy of multilingual_kws_tpu/native/src/wavloader.cc, built
// by native/__init__.py.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Reader {
  FILE* f;
  explicit Reader(const char* path) : f(std::fopen(path, "rb")) {}
  ~Reader() {
    if (f) std::fclose(f);
  }
  bool read(void* dst, size_t n) { return std::fread(dst, 1, n, f) == n; }
  bool skip(long n) { return std::fseek(f, n, SEEK_CUR) == 0; }
};

uint32_t le32(const unsigned char* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}
uint16_t le16(const unsigned char* p) { return uint16_t(p[0]) | uint16_t(p[1]) << 8; }

int load_one(const char* path, int desired_samples, int16_t* out) {
  Reader r(path);
  if (!r.f) return 1;
  unsigned char hdr[12];
  if (!r.read(hdr, 12)) return 3;
  if (std::memcmp(hdr, "RIFF", 4) != 0 || std::memcmp(hdr + 8, "WAVE", 4) != 0)
    return 3;

  int channels = 0, bits = 0;
  bool have_fmt = false;
  // walk chunks until the data chunk
  for (;;) {
    unsigned char ch[8];
    if (!r.read(ch, 8)) return 3;
    uint32_t size = le32(ch + 4);
    if (std::memcmp(ch, "fmt ", 4) == 0) {
      if (size < 16) return 3;
      unsigned char fmt[16];
      if (!r.read(fmt, 16)) return 3;
      uint16_t audio_format = le16(fmt);
      channels = le16(fmt + 2);
      bits = le16(fmt + 14);
      if (audio_format != 1 || bits != 16 || channels < 1) return 2;
      have_fmt = true;
      if (size > 16 && !r.skip(long(size - 16))) return 3;
      if (size % 2 && !r.skip(1)) return 3;
    } else if (std::memcmp(ch, "data", 4) == 0) {
      if (!have_fmt) return 3;
      const size_t frame_bytes = size_t(channels) * 2;
      size_t frames_in_file = size / frame_bytes;
      size_t want = size_t(desired_samples) < frames_in_file
                        ? size_t(desired_samples)
                        : frames_in_file;
      if (channels == 1) {
        if (!r.read(out, want * 2)) return 3;
      } else {
        std::vector<int16_t> frame(channels);
        for (size_t i = 0; i < want; ++i) {
          if (!r.read(frame.data(), frame_bytes)) return 3;
          out[i] = frame[0];
        }
      }
      if (want < size_t(desired_samples))
        std::memset(out + want, 0, (size_t(desired_samples) - want) * 2);
      return 0;
    } else {
      if (!r.skip(long(size + (size % 2)))) return 3;
    }
  }
}

}  // namespace

extern "C" {

// paths: num_files null-terminated strings, concatenated back to back.
// out: (num_files, desired_samples) int16, fully overwritten for ok rows.
// status: (num_files,) int32 per-file code. Rows with nonzero status are
// zero-filled (the caller retries them in Python).
void wl_load_batch(const char* paths, int num_files, int desired_samples,
                   int num_threads, int16_t* out, int32_t* status) {
  std::vector<const char*> ptrs(num_files);
  const char* p = paths;
  for (int i = 0; i < num_files; ++i) {
    ptrs[i] = p;
    p += std::strlen(p) + 1;
  }
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= num_files) return;
      int16_t* row = out + size_t(i) * desired_samples;
      int code = load_one(ptrs[i], desired_samples, row);
      if (code != 0) std::memset(row, 0, size_t(desired_samples) * 2);
      status[i] = code;
    }
  };
  if (num_threads == 1 || num_files == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  int n = num_threads < num_files ? num_threads : num_files;
  threads.reserve(n);
  for (int t = 0; t < n; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
