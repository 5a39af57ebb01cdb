// Native threaded batch loader: JPEG/PNG decode + staging resize — the
// port's own copy of the JAX package's loader (same decoders, same
// `.rawmask` sidecar format, so either package reads the other's sidecars).
//
// Replaces the reference's torch DataLoader worker processes
// (Segmentation/deeplabv3+/train.py:507-512 — num_workers=4, pin_memory):
// the python loop only shuffles indices; this extension decodes a whole
// batch with libjpeg/libpng across a std::thread pool and writes
// fixed-shape uint8 arrays straight into caller-provided (numpy) buffers.
// Exposed through ctypes (plain C ABI), so calls release the GIL for the
// entire batch.
//
// Build: cervical_tpu_torch/native/__init__.py (g++ -O3 -shared -ljpeg
// -lpng, into cervical_tpu_torch/_build/ at first use).

#include <atomic>
#include <cstdint>
#include <sys/stat.h>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  std::vector<uint8_t> data;  // interleaved
  int h = 0, w = 0, c = 0;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t got = fread(out->data(), 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(const std::vector<uint8_t>& bytes, Image* img) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, bytes.data(), bytes.size());
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img->h = cinfo.output_height;
  img->w = cinfo.output_width;
  img->c = 3;
  img->data.resize(size_t(img->h) * img->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img->data.data() + size_t(cinfo.output_scanline) * img->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Palette ("P"-mode) PNGs carry class IDs as palette *indices* — the VOC
// convention, and what tools/labelme.py writes.  PIL's np.asarray on a 'P'
// image returns those raw indices, but libpng's simplified API
// (PNG_FORMAT_GRAY) composites them through the colormap to luminance,
// which would silently corrupt every label.  The IHDR chunk sits at a fixed
// offset (8-byte signature + 4 length + 4 "IHDR" + 13-byte payload whose
// byte 9 is the color type), so palette streams are detected cheaply and
// routed to a full-API decode that skips palette expansion.
bool png_is_palette(const std::vector<uint8_t>& bytes) {
  return bytes.size() > 25 && memcmp(bytes.data() + 12, "IHDR", 4) == 0 &&
         bytes[25] == PNG_COLOR_TYPE_PALETTE;
}

struct PngReadCtx {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_mem_read(png_structp p, png_bytep out, png_size_t n) {
  PngReadCtx* c = static_cast<PngReadCtx*>(png_get_io_ptr(p));
  if (c->pos + n > c->size) png_error(p, "read past end of PNG buffer");
  memcpy(out, c->data + c->pos, n);
  c->pos += n;
}

bool decode_png_palette_indices(const std::vector<uint8_t>& bytes,
                                Image* img) {
  // locals with destructors are declared before setjmp (longjmp must not
  // skip their construction/destruction)
  PngReadCtx ctx{bytes.data(), bytes.size(), 0};
  std::vector<png_bytep> rows;
  png_structp p = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                         nullptr, nullptr);
  if (!p) return false;
  png_infop info = png_create_info_struct(p);
  if (!info) {
    png_destroy_read_struct(&p, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(p))) {
    png_destroy_read_struct(&p, &info, nullptr);
    return false;
  }
  png_set_read_fn(p, &ctx, png_mem_read);
  png_read_info(p, info);
  if (png_get_color_type(p, info) != PNG_COLOR_TYPE_PALETTE) {
    png_destroy_read_struct(&p, &info, nullptr);
    return false;
  }
  png_set_packing(p);  // 1/2/4-bit indices -> one byte per pixel
  png_set_interlace_handling(p);
  png_read_update_info(p, info);
  img->h = static_cast<int>(png_get_image_height(p, info));
  img->w = static_cast<int>(png_get_image_width(p, info));
  img->c = 1;
  if (img->h <= 0 || img->w <= 0 ||
      png_get_rowbytes(p, info) != static_cast<size_t>(img->w)) {
    png_destroy_read_struct(&p, &info, nullptr);
    return false;
  }
  img->data.resize(size_t(img->h) * img->w);
  rows.resize(img->h);
  for (int y = 0; y < img->h; ++y)
    rows[y] = img->data.data() + size_t(y) * img->w;
  png_read_image(p, rows.data());
  png_destroy_read_struct(&p, &info, nullptr);
  return true;
}

bool decode_png_gray(const std::vector<uint8_t>& bytes, Image* img) {
  if (png_is_palette(bytes)) return decode_png_palette_indices(bytes, img);
  png_image pimg;
  memset(&pimg, 0, sizeof(pimg));
  pimg.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&pimg, bytes.data(), bytes.size()))
    return false;
  pimg.format = PNG_FORMAT_GRAY;
  img->h = pimg.height;
  img->w = pimg.width;
  img->c = 1;
  img->data.resize(PNG_IMAGE_SIZE(pimg));
  if (!png_image_finish_read(&pimg, nullptr, img->data.data(), 0, nullptr)) {
    png_image_free(&pimg);
    return false;
  }
  return true;
}

// bilinear (half-pixel) resize for RGB; nearest for masks.
// chan_stride/pix_stride select interleaved (1, 3) vs planar (oh*ow, 1)
// output — the warp kernels (ops/warp.augment_batch_kernels(planar=True))
// read channel-planar batches as they come.
void resize_rgb(const Image& src, uint8_t* dst, int oh, int ow,
                size_t chan_stride = 1, size_t pix_stride = 3) {
  for (int y = 0; y < oh; ++y) {
    float sy = (y + 0.5f) * src.h / oh - 0.5f;
    if (sy < 0) sy = 0;
    if (sy > src.h - 1) sy = float(src.h - 1);
    int y0 = int(sy);
    int y1 = y0 + 1 < src.h ? y0 + 1 : y0;
    float fy = sy - y0;
    for (int x = 0; x < ow; ++x) {
      float sx = (x + 0.5f) * src.w / ow - 0.5f;
      if (sx < 0) sx = 0;
      if (sx > src.w - 1) sx = float(src.w - 1);
      int x0 = int(sx);
      int x1 = x0 + 1 < src.w ? x0 + 1 : x0;
      float fx = sx - x0;
      for (int ch = 0; ch < 3; ++ch) {
        float v00 = src.data[(size_t(y0) * src.w + x0) * 3 + ch];
        float v01 = src.data[(size_t(y0) * src.w + x1) * 3 + ch];
        float v10 = src.data[(size_t(y1) * src.w + x0) * 3 + ch];
        float v11 = src.data[(size_t(y1) * src.w + x1) * 3 + ch];
        float v = v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) +
                  v10 * (1 - fx) * fy + v11 * fx * fy;
        dst[(size_t(y) * ow + x) * pix_stride + ch * chan_stride] =
            uint8_t(v + 0.5f);
      }
    }
  }
}

// --- raw mask sidecars -----------------------------------------------------
// PNG inflate dominates mask decode on small-core hosts: after the first
// epoch, masks are re-read from an uncompressed sidecar `<png>.rawmask`
// (header: magic, png byte size + mtime for freshness, h, w).  Size alone
// can collide (a regenerated PNG of identical byte size would silently
// serve stale labels), so the source PNG's mtime (nanosecond resolution
// where the filesystem provides it) is part of the freshness check.

// "CRM3" — bumped when the mask decoder semantics change, so sidecars
// written by an older decoder are invalidated and re-decoded (CRM2 sidecars
// could carry luminance-composited labels from before the palette-PNG fix;
// CRM1 lacked mtime).
constexpr uint32_t kSidecarMagic = 0x43524D33;

struct SidecarHeader {
  uint32_t magic;
  uint32_t png_size;
  int32_t h, w;
  int64_t png_mtime_ns;
};

// size + mtime (ns) of a file; returns false if unstatable
bool file_stat(const char* path, long* size, int64_t* mtime_ns) {
  struct stat st;
  if (stat(path, &st) != 0) return false;
  *size = static_cast<long>(st.st_size);
  *mtime_ns = static_cast<int64_t>(st.st_mtim.tv_sec) * 1000000000 +
              st.st_mtim.tv_nsec;
  return true;
}

bool read_sidecar(const std::string& path, long png_size, int64_t png_mtime,
                  Image* img) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  SidecarHeader hd;
  if (fread(&hd, sizeof(hd), 1, f) != 1 || hd.magic != kSidecarMagic ||
      hd.png_size != static_cast<uint32_t>(png_size) ||
      hd.png_mtime_ns != png_mtime || hd.h <= 0 || hd.w <= 0) {
    fclose(f);
    return false;
  }
  img->h = hd.h;
  img->w = hd.w;
  img->c = 1;
  img->data.resize(size_t(hd.h) * hd.w);
  bool ok = fread(img->data.data(), 1, img->data.size(), f) ==
            img->data.size();
  fclose(f);
  return ok;
}

void write_sidecar(const std::string& path, long png_size, int64_t png_mtime,
                   const Image& img) {
  // best-effort (read-only dataset dirs are fine): temp file + rename so a
  // concurrent reader never sees a torn sidecar
  std::string tmp = path + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return;
  SidecarHeader hd{kSidecarMagic, static_cast<uint32_t>(png_size),
                   img.h, img.w, png_mtime};
  bool ok = fwrite(&hd, sizeof(hd), 1, f) == 1 &&
            fwrite(img.data.data(), 1, img.data.size(), f) == img.data.size();
  fclose(f);
  if (ok) {
    rename(tmp.c_str(), path.c_str());
  } else {
    remove(tmp.c_str());
  }
}

void resize_nearest_gray(const Image& src, uint8_t* dst, int oh, int ow) {
  for (int y = 0; y < oh; ++y) {
    int sy = int((y + 0.5f) * src.h / oh);
    if (sy > src.h - 1) sy = src.h - 1;
    for (int x = 0; x < ow; ++x) {
      int sx = int((x + 0.5f) * src.w / ow);
      if (sx > src.w - 1) sx = src.w - 1;
      dst[size_t(y) * ow + x] = src.data[size_t(sy) * src.w + sx];
    }
  }
}

}  // namespace

extern "C" {

// Decode n (jpeg image, png mask) pairs into preallocated buffers:
//   imgs: n * stage_h * stage_w * 3 uint8 — NHWC, or channel-planar
//         (n, 3, stage_h, stage_w) when planar != 0 (the layout the warp
//         kernels read; free at decode time vs an on-device transpose)
//   lbls: n * stage_h * stage_w uint8
// use_mask_cache != 0 reads/writes uncompressed `<png>.rawmask` sidecars
// (best-effort; stale sidecars are detected via the PNG's byte size+mtime).
// Returns the number of failures (0 == all good). Failed slots are zeroed.
int fill_batch(const char** jpg_paths, const char** png_paths, int n,
               uint8_t* imgs, uint8_t* lbls, int stage_h, int stage_w,
               int num_threads, int use_mask_cache, int planar) {
  const size_t plane = size_t(stage_h) * stage_w;
  const size_t chan_stride = planar ? plane : 1;
  const size_t pix_stride = planar ? 1 : 3;
  std::atomic<int> failures{0};
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* img_dst = imgs + size_t(i) * stage_h * stage_w * 3;
      uint8_t* lbl_dst = lbls + size_t(i) * stage_h * stage_w;
      std::vector<uint8_t> bytes;
      Image im;
      bool ok = read_file(jpg_paths[i], &bytes) && decode_jpeg(bytes, &im);
      if (ok) {
        if (im.h == stage_h && im.w == stage_w) {
          if (planar) {
            const uint8_t* s = im.data.data();
            for (size_t p = 0; p < plane; ++p) {
              img_dst[p] = s[p * 3];
              img_dst[plane + p] = s[p * 3 + 1];
              img_dst[2 * plane + p] = s[p * 3 + 2];
            }
          } else {
            memcpy(img_dst, im.data.data(), im.data.size());
          }
        } else {
          resize_rgb(im, img_dst, stage_h, stage_w, chan_stride, pix_stride);
        }
      } else {
        memset(img_dst, 0, size_t(stage_h) * stage_w * 3);
        failures.fetch_add(1);
      }
      if (png_paths && png_paths[i]) {
        Image msk;
        bool mok = false;
        std::string side;
        long png_size = -1;
        int64_t png_mtime = 0;
        bool statted = false;
        if (use_mask_cache) {
          statted = file_stat(png_paths[i], &png_size, &png_mtime);
          side = std::string(png_paths[i]) + ".rawmask";
          mok = statted && png_size > 0 &&
                read_sidecar(side, png_size, png_mtime, &msk);
        }
        if (!mok) {
          mok = read_file(png_paths[i], &bytes) &&
                decode_png_gray(bytes, &msk);
          if (mok && use_mask_cache && statted && png_size > 0)
            write_sidecar(side, png_size, png_mtime, msk);
        }
        if (mok) {
          if (msk.h == stage_h && msk.w == stage_w) {
            memcpy(lbl_dst, msk.data.data(), msk.data.size());
          } else {
            resize_nearest_gray(msk, lbl_dst, stage_h, stage_w);
          }
        } else {
          memset(lbl_dst, 0, size_t(stage_h) * stage_w);
          failures.fetch_add(1);
        }
      }
    }
  };
  int t = num_threads > 0 ? num_threads : 4;
  if (t > n) t = n > 0 ? n : 1;
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
