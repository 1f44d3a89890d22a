// Native host-side PNG batch decoder and encoder of srcgan_tpu_torch's input
// and evaluation pipelines (the port's copy of srcgan_tpu/data/_native/loader.cc).
//
// PNG decode feeds the train step on a cold first epoch (later epochs can ride
// the uint8 memmap cache), and PNG encode (zlib) is the host side of a batched
// evaluation pass.  Both take a whole batch and fan it out over C++ threads,
// with no Python per image and no GIL; Python binds them through ctypes
// (srcgan_tpu_torch/data/native.py).  Optional: where g++ or libpng's header
// is missing the package uses PIL.
//
// Build: g++ -O2 -shared -fPIC loader.cc -lpng -o _loader.so
#include <png.h>

#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Probe image dimensions.  Returns 0 on success.
int srcgan_png_probe(const char* path, int* w, int* h) {
  png_image img;
  std::memset(&img, 0, sizeof img);
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&img, path)) return -1;
  *w = static_cast<int>(img.width);
  *h = static_cast<int>(img.height);
  png_image_free(&img);
  return 0;
}

// Decode one PNG as RGB8 into out (h*w*3 bytes, row-major).
// Returns 0 ok, -1 open/parse failure, -2 size mismatch, -3 read failure.
int srcgan_png_decode(const char* path, unsigned char* out, int h, int w) {
  png_image img;
  std::memset(&img, 0, sizeof img);
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&img, path)) return -1;
  img.format = PNG_FORMAT_RGB;
  if (static_cast<int>(img.height) != h || static_cast<int>(img.width) != w) {
    png_image_free(&img);
    return -2;
  }
  if (!png_image_finish_read(&img, nullptr, out, w * 3, nullptr)) return -3;
  return 0;
}

// Decode n PNGs into out (n*h*w*3) with `threads` worker threads.
// Returns 0 on success, or (index+1) of a failed file.
int srcgan_png_decode_batch(const char** paths, int n, unsigned char* out,
                            int h, int w, int threads) {
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  const size_t stride = static_cast<size_t>(h) * w * 3;
  auto worker = [&] {
    int i;
    while ((i = next.fetch_add(1)) < n && err.load() == 0) {
      if (srcgan_png_decode(paths[i], out + stride * i, h, w) != 0)
        err.store(i + 1);
    }
  };
  int t = threads < 1 ? 1 : threads;
  if (t > n) t = n;
  std::vector<std::thread> pool;
  pool.reserve(t - 1);
  for (int k = 1; k < t; ++k) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return err.load();
}

// Encode one RGB8 (ch=3) or gray8 (ch=1) image to a PNG file.
// Returns 0 ok, -1 on write failure, -4 on bad channel count.
int srcgan_png_encode(const char* path, const unsigned char* data, int h,
                      int w, int ch) {
  if (ch != 1 && ch != 3) return -4;
  png_image img;
  std::memset(&img, 0, sizeof img);
  img.version = PNG_IMAGE_VERSION;
  img.width = static_cast<png_uint_32>(w);
  img.height = static_cast<png_uint_32>(h);
  img.format = (ch == 3) ? PNG_FORMAT_RGB : PNG_FORMAT_GRAY;
  if (!png_image_write_to_file(&img, path, 0, data, w * ch, nullptr))
    return -1;
  return 0;
}

// Encode n same-shaped images from one (n*h*w*ch) buffer with a thread
// fan-out: the eval tools write one PNG per sample, and zlib compression
// is the host side of a batched eval pass.
// Returns 0 on success, or (index+1) of a failed file.
int srcgan_png_encode_batch(const char** paths, const unsigned char* data,
                            int n, int h, int w, int ch, int threads) {
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  const size_t stride = static_cast<size_t>(h) * w * ch;
  auto worker = [&] {
    int i;
    while ((i = next.fetch_add(1)) < n && err.load() == 0) {
      if (srcgan_png_encode(paths[i], data + stride * i, h, w, ch) != 0)
        err.store(i + 1);
    }
  };
  int t = threads < 1 ? 1 : threads;
  if (t > n) t = n;
  std::vector<std::thread> pool;
  pool.reserve(t - 1);
  for (int k = 1; k < t; ++k) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return err.load();
}

}  // extern "C"
