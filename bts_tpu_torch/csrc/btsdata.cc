// Native data plane for bts_tpu: PNG/JPEG decode + fixed-geometry crops +
// a multi-threaded batch prefetcher.
//
// Reference counterpart: the reference feeds training through tf.data
// (SURVEY.md §2.10), whose decode/crop/prefetch stages are TensorFlow's
// C++ ops.  bts_tpu replaces that dependency with this ~400-line library:
// libpng/libjpeg decode, KB-crop / NYU-border-crop applied during the copy
// out of the row buffers (no second pass), and a pthread pool that keeps a
// bounded queue of fully-assembled uint8/float32 batches ahead of the
// device step.  Python binds via ctypes (bts_tpu/data/native_loader.py)
// and falls back to PIL when the .so is absent.
//
// Crop modes: 0 = none, 1 = KITTI KB-crop (352x1216, top = h-352,
// left = (w-1216)/2), 2 = NYU border crop (rows 45:472, cols 43:608).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <map>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <png.h>
#include <jpeglib.h>
#include <csetjmp>

namespace {

constexpr int kKbH = 352, kKbW = 1216;
constexpr int kNyuTop = 45, kNyuBot = 472, kNyuLeft = 43, kNyuRight = 608;

struct CropBox {
  int top, left, h, w;
};

CropBox crop_box(int mode, int h, int w) {
  if (mode == 1) return {h - kKbH, (w - kKbW) / 2, kKbH, kKbW};
  if (mode == 2) return {kNyuTop, kNyuLeft, kNyuBot - kNyuTop, kNyuRight - kNyuLeft};
  return {0, 0, h, w};
}

bool is_png(FILE* f) {
  unsigned char sig[8];
  if (fread(sig, 1, 8, f) != 8) return false;
  rewind(f);
  return png_sig_cmp(sig, 0, 8) == 0;
}

// ---------------------------------------------------------------- PNG RGB --
bool decode_png_rgb(FILE* f, int crop_mode, uint8_t* out, int* out_h, int* out_w) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  int h = png_get_image_height(png, info);
  int w = png_get_image_width(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  CropBox cb = crop_box(crop_mode, h, w);
  if (cb.top < 0 || cb.left < 0 || cb.top + cb.h > h || cb.left + cb.w > w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  std::vector<uint8_t> row(png_get_rowbytes(png, info));
  // stream rows; copy only the cropped window
  for (int y = 0; y < cb.top + cb.h; ++y) {
    png_read_row(png, row.data(), nullptr);
    if (y >= cb.top)
      memcpy(out + (size_t)(y - cb.top) * cb.w * 3, row.data() + (size_t)cb.left * 3,
             (size_t)cb.w * 3);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  *out_h = cb.h;
  *out_w = cb.w;
  return true;
}

// -------------------------------------------------------------- PNG depth --
bool decode_png_depth(FILE* f, int crop_mode, float inv_scale, float* out, int* out_h,
                      int* out_w) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  int h = png_get_image_height(png, info);
  int w = png_get_image_width(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  png_byte color = png_get_color_type(png, info);
  if (color != PNG_COLOR_TYPE_GRAY) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_read_update_info(png, info);

  CropBox cb = crop_box(crop_mode, h, w);
  if (cb.top < 0 || cb.left < 0 || cb.top + cb.h > h || cb.left + cb.w > w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  std::vector<uint8_t> row(png_get_rowbytes(png, info));
  for (int y = 0; y < cb.top + cb.h; ++y) {
    png_read_row(png, row.data(), nullptr);
    if (y < cb.top) continue;
    float* dst = out + (size_t)(y - cb.top) * cb.w;
    if (depth == 16) {
      // PNG 16-bit is big-endian
      const uint8_t* src = row.data() + (size_t)cb.left * 2;
      for (int x = 0; x < cb.w; ++x)
        dst[x] = (float)((src[2 * x] << 8) | src[2 * x + 1]) * inv_scale;
    } else {
      const uint8_t* src = row.data() + cb.left;
      for (int x = 0; x < cb.w; ++x) dst[x] = (float)src[x] * inv_scale;
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  *out_h = cb.h;
  *out_w = cb.w;
  return true;
}

// ------------------------------------------------------------------- JPEG --
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

bool decode_jpeg_rgb(FILE* f, int crop_mode, uint8_t* out, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int h = cinfo.output_height, w = cinfo.output_width;
  CropBox cb = crop_box(crop_mode, h, w);
  if (cb.top < 0 || cb.left < 0 || cb.top + cb.h > h || cb.left + cb.w > w) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  std::vector<uint8_t> row((size_t)w * 3);
  uint8_t* rowp = row.data();
  for (int y = 0; y < cb.top + cb.h; ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    if (y >= cb.top)
      memcpy(out + (size_t)(y - cb.top) * cb.w * 3, row.data() + (size_t)cb.left * 3,
             (size_t)cb.w * 3);
  }
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = cb.h;
  *out_w = cb.w;
  return true;
}

}  // namespace

extern "C" {

// Decode an RGB image (PNG or JPEG sniffed by signature) with crop applied.
// out must hold crop_h*crop_w*3 bytes; returns 0 on success.
int bts_decode_rgb(const char* path, int crop_mode, uint8_t* out, int* out_h, int* out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  bool ok = is_png(f) ? decode_png_rgb(f, crop_mode, out, out_h, out_w)
                      : decode_jpeg_rgb(f, crop_mode, out, out_h, out_w);
  fclose(f);
  return ok ? 0 : 2;
}

// Decode a uint16 grayscale depth PNG -> float32 meters (value * inv_scale).
int bts_decode_depth(const char* path, int crop_mode, float inv_scale, float* out, int* out_h,
                     int* out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  bool ok = decode_png_depth(f, crop_mode, inv_scale, out, out_h, out_w);
  fclose(f);
  return ok ? 0 : 2;
}

// ------------------------------------------------------- in-memory decode --
// The ArrayRecord path (bts_tpu/data/records.py) carries already-encoded
// PNG/JPEG bytes inside record payloads — no file to fopen.  fmemopen wraps
// the payload in a FILE* so the exact same decode paths run; the caller
// peeks dimensions first (fixed-offset IHDR for PNG, SOF scan for JPEG) to
// size the output buffer, since records — unlike the fixed-geometry batch
// loader — are decoded at their source size (crop happens downstream,
// shared with the PIL path).

// Parse encoded image dims without decoding.  Returns 0 and fills h/w, or
// nonzero if the header is unrecognized/truncated.
int bts_peek_dims(const uint8_t* buf, long len, int* h, int* w) {
  static const unsigned char png_sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len >= 24 && memcmp(buf, png_sig, 8) == 0) {
    // 8-byte signature, 4-byte IHDR length, 4-byte "IHDR", then w,h (BE u32)
    *w = (buf[16] << 24) | (buf[17] << 16) | (buf[18] << 8) | buf[19];
    *h = (buf[20] << 24) | (buf[21] << 16) | (buf[22] << 8) | buf[23];
    return (*w > 0 && *h > 0) ? 0 : 2;
  }
  if (len >= 4 && buf[0] == 0xFF && buf[1] == 0xD8) {  // JPEG SOI
    long off = 2;
    while (off + 9 < len) {
      if (buf[off] != 0xFF) return 2;  // lost marker sync
      uint8_t m = buf[off + 1];
      if (m == 0xFF) { off++; continue; }         // fill byte
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD9))  // standalone markers
        { off += 2; continue; }
      long seg = ((long)buf[off + 2] << 8) | buf[off + 3];
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        // SOFn: [len][precision][h hi][h lo][w hi][w lo]
        *h = (buf[off + 5] << 8) | buf[off + 6];
        *w = (buf[off + 7] << 8) | buf[off + 8];
        return (*w > 0 && *h > 0) ? 0 : 2;
      }
      off += 2 + seg;
    }
    return 2;
  }
  return 2;
}

int bts_decode_rgb_mem(const uint8_t* buf, long len, int crop_mode, uint8_t* out, int* out_h,
                       int* out_w) {
  FILE* f = fmemopen((void*)buf, (size_t)len, "rb");
  if (!f) return 1;
  bool ok = is_png(f) ? decode_png_rgb(f, crop_mode, out, out_h, out_w)
                      : decode_jpeg_rgb(f, crop_mode, out, out_h, out_w);
  fclose(f);
  return ok ? 0 : 2;
}

int bts_decode_depth_mem(const uint8_t* buf, long len, int crop_mode, float inv_scale, float* out,
                         int* out_h, int* out_w) {
  FILE* f = fmemopen((void*)buf, (size_t)len, "rb");
  if (!f) return 1;
  bool ok = decode_png_depth(f, crop_mode, inv_scale, out, out_h, out_w);
  fclose(f);
  return ok ? 0 : 2;
}

// ------------------------------------------------------- batch prefetcher --
// Python hands over the full sample table and, per epoch, an index order;
// worker threads decode samples and assemble contiguous batches; next()
// blocks on a bounded queue (depth `prefetch`).

struct Batch {
  std::vector<uint8_t> images;  // B*H*W*3
  std::vector<float> depths;    // B*H*W (empty if !with_depth)
  std::vector<float> focals;    // B
};

struct Loader {
  std::vector<std::string> img_paths, depth_paths;
  std::vector<float> focals;
  int batch, h, w, crop_mode;
  float inv_scale;
  bool with_depth;

  std::vector<int> order;
  size_t next_batch = 0, n_batches = 0;
  std::mutex work_mu;

  // seq-keyed: workers can finish out of order; next() pops emit_seq
  std::map<size_t, Batch*> done;
  size_t emit_seq = 0;
  std::mutex done_mu;
  std::condition_variable done_cv;
  size_t max_queue;

  std::vector<std::thread> threads;
  std::atomic<bool> stop{false};
  std::atomic<int> errors{0};

  void worker() {
    while (!stop.load()) {
      size_t seq;
      {
        std::lock_guard<std::mutex> lk(work_mu);
        if (next_batch >= n_batches) return;
        seq = next_batch++;
      }
      // bound the queue: wait until our slot is within the window
      {
        std::unique_lock<std::mutex> lk(done_mu);
        done_cv.wait(lk, [&] { return stop.load() || seq < emit_seq + max_queue; });
        if (stop.load()) return;
      }
      Batch* b = new Batch;
      b->images.resize((size_t)batch * h * w * 3);
      if (with_depth) b->depths.resize((size_t)batch * h * w);
      b->focals.resize(batch);
      for (int i = 0; i < batch; ++i) {
        int idx = order[seq * batch + i];
        int oh = 0, ow = 0;
        if (bts_decode_rgb(img_paths[idx].c_str(), crop_mode,
                           b->images.data() + (size_t)i * h * w * 3, &oh, &ow) != 0 ||
            oh != h || ow != w)
          errors.fetch_add(1);
        if (with_depth) {
          float* dst = b->depths.data() + (size_t)i * h * w;
          if (depth_paths[idx].empty()) {
            memset(dst, 0, (size_t)h * w * sizeof(float));
          } else if (bts_decode_depth(depth_paths[idx].c_str(), crop_mode, inv_scale, dst, &oh,
                                      &ow) != 0 ||
                     oh != h || ow != w) {
            errors.fetch_add(1);
          }
        }
        b->focals[i] = focals[idx];
      }
      {
        std::lock_guard<std::mutex> lk(done_mu);
        done[seq] = b;
      }
      done_cv.notify_all();
    }
  }
};

void* bts_loader_create(const char** img_paths, const char** depth_paths, const float* focals,
                        int n, int batch, int h, int w, int crop_mode, float inv_scale,
                        int with_depth, int num_threads, int prefetch) {
  Loader* L = new Loader;
  L->img_paths.reserve(n);
  L->depth_paths.reserve(n);
  for (int i = 0; i < n; ++i) {
    L->img_paths.emplace_back(img_paths[i]);
    L->depth_paths.emplace_back(depth_paths && depth_paths[i] ? depth_paths[i] : "");
    L->focals.push_back(focals ? focals[i] : 0.f);
  }
  L->batch = batch;
  L->h = h;
  L->w = w;
  L->crop_mode = crop_mode;
  L->inv_scale = inv_scale;
  L->with_depth = with_depth != 0;
  L->max_queue = prefetch > 0 ? prefetch : 2;
  L->threads.reserve(num_threads > 0 ? num_threads : 1);
  (void)num_threads;
  return L;
}

// Start an epoch with the given sample order (length must be a multiple of
// batch; Python drops the remainder / shuffles).
int bts_loader_start_epoch(void* handle, const int* order, int n, int num_threads) {
  Loader* L = reinterpret_cast<Loader*>(handle);
  if (!L->threads.empty()) return 1;  // previous epoch still running
  if (n % L->batch != 0) return 2;
  L->order.assign(order, order + n);
  L->next_batch = 0;
  L->emit_seq = 0;
  L->n_batches = n / L->batch;
  L->stop.store(false);
  L->errors.store(0);
  int t = num_threads > 0 ? num_threads : 1;
  for (int i = 0; i < t; ++i) L->threads.emplace_back(&Loader::worker, L);
  return 0;
}

// Blocking next; copies into caller buffers. Returns 0 ok, 1 epoch done.
int bts_loader_next(void* handle, uint8_t* images, float* depths, float* focals) {
  Loader* L = reinterpret_cast<Loader*>(handle);
  if (L->emit_seq >= L->n_batches) return 1;
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(L->done_mu);
    L->done_cv.wait(lk, [&] { return L->done.count(L->emit_seq) != 0; });
    b = L->done[L->emit_seq];
    L->done.erase(L->emit_seq);
    L->emit_seq++;
  }
  L->done_cv.notify_all();
  memcpy(images, b->images.data(), b->images.size());
  if (depths && !b->depths.empty())
    memcpy(depths, b->depths.data(), b->depths.size() * sizeof(float));
  if (focals) memcpy(focals, b->focals.data(), b->focals.size() * sizeof(float));
  delete b;
  if (L->emit_seq >= L->n_batches) {
    for (auto& th : L->threads) th.join();
    L->threads.clear();
  }
  return 0;
}

int bts_loader_errors(void* handle) {
  return reinterpret_cast<Loader*>(handle)->errors.load();
}

void bts_loader_destroy(void* handle) {
  Loader* L = reinterpret_cast<Loader*>(handle);
  L->stop.store(true);
  L->done_cv.notify_all();
  for (auto& th : L->threads)
    if (th.joinable()) th.join();
  {
    std::lock_guard<std::mutex> lk(L->done_mu);
    for (auto& kv : L->done) delete kv.second;
    L->done.clear();
  }
  delete L;
}

}  // extern "C"
