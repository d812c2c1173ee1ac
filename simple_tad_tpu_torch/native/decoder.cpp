// Native clip decoder: ZIP archive reading + JPEG decode, multithreaded.
//
// Copy of native/decoder.cpp (the JAX package's decoder), so that the
// PyTorch port stands alone: one call decodes a whole clip's frames from
// images.zip into a caller-provided contiguous RGB buffer, with a
// persistent worker pool doing inflate+JPEG decode in parallel.
//
// Exposed C ABI (consumed via ctypes from
// simple_tad_tpu_torch/data/native.py):
//   stt_open_zip(path)                  -> handle (caches central directory)
//   stt_close_zip(handle)
//   stt_zip_num_entries(handle)
//   stt_zip_entry_name(handle, i)       -> const char*
//   stt_decode_frames(handle, names, n, out, h, w) -> 0 on success
//        decodes n entries into out[n, h, w, 3] uint8 RGB; (h, w) must
//        match the JPEG dimensions (pass 0,0 to use stt_probe first)
//   stt_probe(handle, name, &h, &w)     -> image dimensions
//
// Built at first use by simple_tad_tpu_torch/data/native.py:build_native
// (g++ -O3 -std=c++17 -fPIC -shared -ljpeg -lz -lpthread) into the
// git-ignored build/ directory beside the package.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ----------------------------------------------------------- thread pool --
class ThreadPool {
 public:
  explicit ThreadPool(size_t n) : stop_(false) {
    for (size_t i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      tasks_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

ThreadPool& pool() {
  static ThreadPool* p = new ThreadPool(
      std::max(2u, std::thread::hardware_concurrency()));
  return *p;
}

// ------------------------------------------------------------- zip reader --
struct ZipEntry {
  uint64_t offset;       // offset of local file header
  uint32_t comp_size;
  uint32_t uncomp_size;
  uint16_t method;       // 0 = stored, 8 = deflate
};

struct ZipFile {
  FILE* fp = nullptr;
  std::mutex io_mu;
  std::vector<std::string> names;
  std::unordered_map<std::string, ZipEntry> entries;
};

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

ZipFile* zip_open(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  // find End Of Central Directory (scan last 66000 bytes for signature)
  fseek(fp, 0, SEEK_END);
  long fsize = ftell(fp);
  long scan = fsize < 66000 ? fsize : 66000;
  std::vector<uint8_t> tail(scan);
  fseek(fp, fsize - scan, SEEK_SET);
  if (fread(tail.data(), 1, scan, fp) != (size_t)scan) {
    fclose(fp);
    return nullptr;
  }
  long eocd = -1;
  for (long i = scan - 22; i >= 0; --i) {
    if (rd32(&tail[i]) == 0x06054b50) {
      eocd = i;
      break;
    }
  }
  if (eocd < 0) {
    fclose(fp);
    return nullptr;
  }
  uint16_t n_entries = rd16(&tail[eocd + 10]);
  uint32_t cd_size = rd32(&tail[eocd + 12]);
  uint32_t cd_offset = rd32(&tail[eocd + 16]);

  std::vector<uint8_t> cd(cd_size);
  fseek(fp, cd_offset, SEEK_SET);
  if (fread(cd.data(), 1, cd_size, fp) != cd_size) {
    fclose(fp);
    return nullptr;
  }
  auto* zf = new ZipFile();
  zf->fp = fp;
  size_t pos = 0;
  for (int i = 0; i < n_entries && pos + 46 <= cd_size; ++i) {
    if (rd32(&cd[pos]) != 0x02014b50) break;
    uint16_t method = rd16(&cd[pos + 10]);
    uint32_t comp = rd32(&cd[pos + 20]);
    uint32_t uncomp = rd32(&cd[pos + 24]);
    uint16_t name_len = rd16(&cd[pos + 28]);
    uint16_t extra_len = rd16(&cd[pos + 30]);
    uint16_t comment_len = rd16(&cd[pos + 32]);
    uint32_t local_off = rd32(&cd[pos + 42]);
    std::string name((const char*)&cd[pos + 46], name_len);
    zf->entries[name] = ZipEntry{local_off, comp, uncomp, method};
    zf->names.push_back(name);
    pos += 46 + name_len + extra_len + comment_len;
  }
  return zf;
}

bool zip_read(ZipFile* zf, const std::string& name,
              std::vector<uint8_t>* out) {
  auto it = zf->entries.find(name);
  if (it == zf->entries.end()) return false;
  const ZipEntry& e = it->second;
  std::vector<uint8_t> raw(e.comp_size);
  {
    std::lock_guard<std::mutex> lock(zf->io_mu);
    uint8_t lh[30];
    fseek(zf->fp, e.offset, SEEK_SET);
    if (fread(lh, 1, 30, zf->fp) != 30 || rd32(lh) != 0x04034b50)
      return false;
    uint16_t name_len = rd16(lh + 26);
    uint16_t extra_len = rd16(lh + 28);
    fseek(zf->fp, e.offset + 30 + name_len + extra_len, SEEK_SET);
    if (fread(raw.data(), 1, e.comp_size, zf->fp) != e.comp_size)
      return false;
  }
  if (e.method == 0) {
    *out = std::move(raw);
    return true;
  }
  if (e.method == 8) {
    out->resize(e.uncomp_size);
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;
    zs.next_in = raw.data();
    zs.avail_in = e.comp_size;
    zs.next_out = out->data();
    zs.avail_out = e.uncomp_size;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return rc == Z_STREAM_END;
  }
  return false;
}

// ------------------------------------------------------------ jpeg decode --
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(((JpegErr*)cinfo->err)->jb, 1);
}

// Decode JPEG bytes to RGB; returns false on error or dim mismatch.
bool jpeg_decode_rgb(const uint8_t* data, size_t size, uint8_t* out,
                     int expect_h, int expect_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_height != expect_h ||
      (int)cinfo.output_width != expect_w ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  int stride = expect_w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool jpeg_probe(const uint8_t* data, size_t size, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace

extern "C" {

void* stt_open_zip(const char* path) { return zip_open(path); }

void stt_close_zip(void* handle) {
  auto* zf = (ZipFile*)handle;
  if (zf) {
    fclose(zf->fp);
    delete zf;
  }
}

int stt_zip_num_entries(void* handle) {
  return (int)((ZipFile*)handle)->names.size();
}

const char* stt_zip_entry_name(void* handle, int i) {
  auto* zf = (ZipFile*)handle;
  if (i < 0 || i >= (int)zf->names.size()) return nullptr;
  return zf->names[i].c_str();
}

int stt_probe(void* handle, const char* name, int* h, int* w) {
  auto* zf = (ZipFile*)handle;
  std::vector<uint8_t> buf;
  if (!zip_read(zf, name, &buf)) return -1;
  return jpeg_probe(buf.data(), buf.size(), h, w) ? 0 : -2;
}

// Decode n frames named names[0..n) into out[n, h, w, 3] uint8 RGB.
int stt_decode_frames(void* handle, const char** names, int n,
                      uint8_t* out, int h, int w) {
  auto* zf = (ZipFile*)handle;
  std::atomic<int> failures(0);
  std::atomic<int> remaining(n);
  std::mutex done_mu;
  std::condition_variable done_cv;
  size_t frame_bytes = (size_t)h * w * 3;

  for (int i = 0; i < n; ++i) {
    std::string name(names[i]);
    uint8_t* dst = out + (size_t)i * frame_bytes;
    pool().submit([zf, name, dst, h, w, &failures, &remaining, &done_mu,
                   &done_cv] {
      std::vector<uint8_t> buf;
      if (!zip_read(zf, name, &buf) ||
          !jpeg_decode_rgb(buf.data(), buf.size(), dst, h, w)) {
        failures.fetch_add(1);
      }
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lock(done_mu);
        done_cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lock(done_mu);
  done_cv.wait(lock, [&] { return remaining.load() == 0; });
  return failures.load();
}

}  // extern "C"
