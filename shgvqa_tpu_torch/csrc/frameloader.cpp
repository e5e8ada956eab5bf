// Native clip loader: threaded PNG/JPEG decode + bilinear resize to RGB888.
//
// The reference's input pipeline spends its time in per-frame cv2.imread
// calls inside 8 DataLoader worker processes (agqa_data.py:206-213).  This
// library decodes a whole clip (16 frames) per call with an internal thread
// pool and writes directly into a caller-provided contiguous buffer that the
// Python side hands to torch.from_numpy — no per-frame Python objects, no
// copies, no worker processes.
//
// Formats are sniffed from the file's magic bytes, not the extension: the
// reference's frame paths say `.png` (agqa_data.py:209) but the upstream
// Charades-v1 frame dump ships JPEGs, and cv2.imread ignores extensions too.
//
// C ABI (ctypes-friendly):
//   int fl_set_threads(int n);
//   int fl_decode_clip(const char** paths, int n_frames,
//                      int out_h, int out_w, unsigned char* out);
//     out must hold n_frames*out_h*out_w*3 bytes; returns 0 on success,
//     -(index+1) for the first frame that failed.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 frameloader.cpp -lpng -ljpeg -lz
//        -pthread (shgvqa_tpu_torch/kernels/_build.py builds it lazily into
//        shgvqa_tpu_torch/_build/; data/native_loader.py binds it)

#include <csetjmp>
#include <cstddef>
#include <cstdio>

// jpeglib.h relies on size_t/FILE being declared by its includer
#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> rgb;  // H*W*3
  int h = 0;
  int w = 0;
};

// Decode one PNG file to 8-bit RGB using libpng's transform pipeline
// (palette/gray/16-bit/alpha all normalized to RGB888).
bool decode_png(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_set_expand(png);               // palette/gray<8/tRNS -> 8-bit
  png_set_strip_16(png);             // 16-bit -> 8-bit
  png_set_strip_alpha(png);          // drop alpha
  png_set_gray_to_rgb(png);          // gray -> RGB
  png_read_update_info(png, info);

  out->h = static_cast<int>(png_get_image_height(png, info));
  out->w = static_cast<int>(png_get_image_width(png, info));
  const size_t rowbytes = png_get_rowbytes(png, info);
  if (rowbytes != static_cast<size_t>(out->w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  out->rgb.resize(static_cast<size_t>(out->h) * out->w * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y) {
    rows[y] = out->rgb.data() + static_cast<size_t>(y) * rowbytes;
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

// libjpeg error handling: the default handler calls exit(); route fatal
// errors through longjmp instead so a truncated frame fails the clip, not
// the process.
struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(err->jmp, 1);
}

// Decode one JPEG file to 8-bit RGB (grayscale promoted to RGB).
bool decode_jpeg(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;   // gray/YCbCr/CMYK -> RGB888
  jpeg_start_decompress(&cinfo);
  out->h = static_cast<int>(cinfo.output_height);
  out->w = static_cast<int>(cinfo.output_width);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  out->rgb.resize(static_cast<size_t>(out->h) * out->w * 3);
  const size_t rowbytes = static_cast<size_t>(out->w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->rgb.data() +
                   static_cast<size_t>(cinfo.output_scanline) * rowbytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return true;
}

// Sniff the magic bytes and dispatch (cv2.imread semantics: the extension
// is not trusted).
bool decode_image(const char* path, Image* out) {
  unsigned char magic[2] = {0, 0};
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  const size_t got = std::fread(magic, 1, 2, fp);
  std::fclose(fp);
  if (got != 2) return false;
  if (magic[0] == 0xFF && magic[1] == 0xD8) return decode_jpeg(path, out);
  return decode_png(path, out);
}

// Bilinear resize HxWx3 -> out_h x out_w x 3 (align_corners=false,
// PIL/torchvision convention).
void resize_bilinear(const Image& src, int out_h, int out_w, uint8_t* dst) {
  const float sy = static_cast<float>(src.h) / out_h;
  const float sx = static_cast<float>(src.w) / out_w;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(fy);
    if (fy < 0) fy = 0, y0 = 0;
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    const float wy = fy - y0;
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(fx);
      if (fx < 0) fx = 0, x0 = 0;
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      const float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src.rgb[(static_cast<size_t>(y0) * src.w + x0) * 3 + c];
        const float v01 = src.rgb[(static_cast<size_t>(y0) * src.w + x1) * 3 + c];
        const float v10 = src.rgb[(static_cast<size_t>(y1) * src.w + x0) * 3 + c];
        const float v11 = src.rgb[(static_cast<size_t>(y1) * src.w + x1) * 3 + c];
        const float top = v00 + wx * (v01 - v00);
        const float bot = v10 + wx * (v11 - v10);
        const float v = top + wy * (bot - top);
        dst[(static_cast<size_t>(oy) * out_w + ox) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

class ThreadPool {
 public:
  explicit ThreadPool(int n) { resize(n); }
  ~ThreadPool() { shutdown(); }

  void resize(int n) {
    shutdown();
    stop_ = false;
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }

  void submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      tasks_.push(std::move(fn));
    }
    cv_.notify_one();
  }

  int size() const { return static_cast<int>(workers_.size()); }

 private:
  void shutdown() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
    workers_.clear();
  }

  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

ThreadPool* pool() {
  static ThreadPool p(std::max(1u, std::thread::hardware_concurrency()));
  return &p;
}

}  // namespace

extern "C" {

int fl_set_threads(int n) {
  if (n < 1) n = 1;
  pool()->resize(n);
  return pool()->size();
}

int fl_decode_clip(const char** paths, int n_frames, int out_h, int out_w,
                   unsigned char* out) {
  std::atomic<int> failed{0};
  std::atomic<int> remaining{n_frames};
  std::mutex done_mu;
  std::condition_variable done_cv;

  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w * 3;
  for (int i = 0; i < n_frames; ++i) {
    pool()->submit([&, i] {
      Image img;
      if (!decode_image(paths[i], &img)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, -(i + 1));
      } else {
        resize_bilinear(img, out_h, out_w, out + frame_bytes * i);
      }
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return failed.load();
}

}  // extern "C"
