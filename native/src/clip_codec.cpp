// RSC clip codec: native decoder/encoder for the framework's recorded-clip
// format (see realsensetracker_tpu/data/recorded.py for the layout spec).
//
// This is the framework's native data-loader, standing in for the
// reference's librealsense capture + protobuf serde (rs_driver.cpp,
// rs_viewer.cpp:105-112): bulk u16->f32 depth conversion happens here in
// C++ with threads, off the Python hot path, feeding the host->device
// streamer.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[8] = {'R', 'S', 'C', 'L', 'I', 'P', '0', '1'};
constexpr char kMagic2[8] = {'R', 'S', 'C', 'L', 'I', 'P', '0', '2'};
constexpr int kDtypeU16Mm = 0;
constexpr int kDtypeF32M = 1;

struct Header {
  int32_t num_frames;
  int32_t height;
  int32_t width;
  int32_t dtype;
  int32_t has_color;  // v2 only; 0 for v1 clips
  float intr[4];      // fx, fy, cx, cy
};

bool ReadHeader(std::FILE* f, Header* h) {
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8) return false;
  const bool v1 = std::memcmp(magic, kMagic, 8) == 0;
  const bool v2 = std::memcmp(magic, kMagic2, 8) == 0;
  if (!v1 && !v2) return false;
  if (std::fread(&h->num_frames, 4, 4, f) != 4) return false;
  h->has_color = 0;
  if (v2) {
    int32_t extra[2];  // has_color, reserved
    if (std::fread(extra, 4, 2, f) != 2) return false;
    h->has_color = extra[0];
  }
  if (std::fread(h->intr, 4, 4, f) != 4) return false;
  return true;
}

int64_t DepthBytes(const Header& h) {
  const int64_t pixels =
      static_cast<int64_t>(h.num_frames) * h.height * h.width;
  return pixels * (h.dtype == kDtypeF32M ? 4 : 2);
}

void ConvertU16Block(const uint16_t* src, float* dst, int64_t n) {
  // Divide (not multiply-by-reciprocal): bit-exact with the Python
  // fallback reader's astype(float32)/1000.0.
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] / 1000.0f;
}

}  // namespace

extern "C" {

// Bumped whenever an exported signature changes; the Python loader
// force-rebuilds when a stale .so reports an older ABI.
// v4: png16 batch decode validates per-file dims against the caller's
// buffer (a larger file used to overflow its fixed-stride slot).
// v5: write_clip rounds half-to-even (np.round parity), clamps NaN depth
// to 0 instead of a UB cast, and fails on short writes (disk full).
int rstpu_abi_version() { return 5; }

// Reads header fields. Returns 0 on success, negative error code otherwise.
int rsc_read_header(const char* path,
                    int32_t* dims /*5: F,H,W,dtype,has_color*/,
                    float* intr /*4*/) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Header h;
  if (!ReadHeader(f, &h)) {
    std::fclose(f);
    return -2;
  }
  dims[0] = h.num_frames;
  dims[1] = h.height;
  dims[2] = h.width;
  dims[3] = h.dtype;
  dims[4] = h.has_color;
  std::memcpy(intr, h.intr, 4 * sizeof(float));
  std::fclose(f);
  return 0;
}

// Reads all frames into caller-allocated buffers:
//   stamps: num_frames doubles; depths: num_frames*H*W floats (meters).
// Multi-threaded u16->f32 conversion. Returns 0 on success.
int rsc_read_frames(const char* path, double* stamps, float* depths,
                    int num_threads) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Header h;
  if (!ReadHeader(f, &h)) {
    std::fclose(f);
    return -2;
  }
  const int64_t count = static_cast<int64_t>(h.num_frames);
  const int64_t pixels = static_cast<int64_t>(h.height) * h.width;
  if (std::fread(stamps, 8, count, f) != static_cast<size_t>(count)) {
    std::fclose(f);
    return -3;
  }
  const int64_t total = count * pixels;
  if (h.dtype == kDtypeF32M) {
    const size_t got = std::fread(depths, 4, total, f);
    std::fclose(f);
    return got == static_cast<size_t>(total) ? 0 : -4;
  }
  if (h.dtype != kDtypeU16Mm) {
    std::fclose(f);
    return -5;
  }
  std::vector<uint16_t> raw(total);
  const size_t got = std::fread(raw.data(), 2, total, f);
  std::fclose(f);
  if (got != static_cast<size_t>(total)) return -4;

  int nt = num_threads > 0 ? num_threads
                           : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt == 1 || total < (1 << 20)) {
    ConvertU16Block(raw.data(), depths, total);
    return 0;
  }
  std::vector<std::thread> workers;
  const int64_t chunk = (total + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t begin = t * chunk;
    const int64_t end = begin + chunk < total ? begin + chunk : total;
    if (begin >= end) break;
    workers.emplace_back(ConvertU16Block, raw.data() + begin, depths + begin,
                         end - begin);
  }
  for (auto& w : workers) w.join();
  return 0;
}

// Reads the v2 color plane into a caller-allocated F*H*W*3 uint8 buffer.
// Returns 0 on success, -6 if the clip has no color plane.
int rsc_read_colors(const char* path, uint8_t* colors) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Header h;
  if (!ReadHeader(f, &h)) {
    std::fclose(f);
    return -2;
  }
  if (!h.has_color) {
    std::fclose(f);
    return -6;
  }
  // Seek past stamps + depth plane (header was consumed by ReadHeader).
  // Chunked SEEK_CUR: a single fseek(long) truncates 64-bit offsets on
  // LLP64 platforms for clips over 2 GiB.
  int64_t skip = 8 * static_cast<int64_t>(h.num_frames) + DepthBytes(h);
  while (skip > 0) {
    const long step =
        skip > 0x40000000 ? 0x40000000L : static_cast<long>(skip);
    if (std::fseek(f, step, SEEK_CUR) != 0) {
      std::fclose(f);
      return -3;
    }
    skip -= step;
  }
  const int64_t total =
      static_cast<int64_t>(h.num_frames) * h.height * h.width * 3;
  const size_t got = std::fread(colors, 1, total, f);
  std::fclose(f);
  return got == static_cast<size_t>(total) ? 0 : -4;
}

// Writes a clip from float32 meter depths as u16 millimeters; colors may be
// null (v1 clip) or an F*H*W*3 uint8 plane (v2 clip).
int rsc_write_clip(const char* path, const double* stamps, const float* depths,
                   int32_t num_frames, int32_t height, int32_t width,
                   const float* intr /*4*/, const uint8_t* colors) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const int64_t total = static_cast<int64_t>(num_frames) * height * width;
  size_t wr = 0;
  if (colors) {
    wr += std::fwrite(kMagic2, 1, 8, f);
    int32_t dims[6] = {num_frames, height, width, kDtypeU16Mm, 1, 0};
    wr += std::fwrite(dims, 4, 6, f) * 4;
  } else {
    wr += std::fwrite(kMagic, 1, 8, f);
    int32_t dims[4] = {num_frames, height, width, kDtypeU16Mm};
    wr += std::fwrite(dims, 4, 4, f) * 4;
  }
  wr += std::fwrite(intr, 4, 4, f) * 4;
  wr += std::fwrite(stamps, 8, num_frames, f) * 8;
  std::vector<uint16_t> mm(total);
  for (int64_t i = 0; i < total; ++i) {
    // nearbyint = round-half-to-even (default FP mode), matching the
    // Python writer's np.round; NaN/inf depths clamp to 0 instead of a
    // UB float->uint16 cast.
    float v = std::nearbyintf(depths[i] * 1000.0f);
    if (!(v > 0.0f)) v = 0.0f;  // also catches NaN
    if (v > 65535.0f) v = 65535.0f;
    mm[i] = static_cast<uint16_t>(v);
  }
  wr += std::fwrite(mm.data(), 2, total, f) * 2;
  if (colors) wr += std::fwrite(colors, 1, total * 3, f);
  const size_t expect = (colors ? 8 + 24 : 8 + 16) + 16 +
                        static_cast<size_t>(num_frames) * 8 + total * 2 +
                        (colors ? total * 3 : 0);
  const bool closed_ok = std::fclose(f) == 0;
  // Short writes (disk full) must not report success: the corruption
  // would otherwise only surface later as an unrelated read error.
  return (wr == expect && closed_ok) ? 0 : -2;
}

}  // extern "C"
