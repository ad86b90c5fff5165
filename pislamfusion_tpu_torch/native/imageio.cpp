// Native image IO + prefetch pipeline for the dataset layer.
//
// Equivalent of the reference's dataset prepare thread + cv::imread
// (gui/IO/DatasetRTMapper.cpp:171-205 background prefetch; OpenCV decode):
// JPEG/PNG decode via libjpeg/libpng, RGB->gray conversion and float32
// staging done here in C++ worker threads — fully off the Python GIL, so
// image decode overlaps SLAM compute exactly like the reference's
// dataset-prepare thread overlaps its tracker.
//
// C ABI only (consumed through ctypes from
// pislamfusion_tpu/io/native_io.py — no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

extern "C" {

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(e->jb, 1);
}

// decode JPEG file -> RGB8 (malloc'd). returns 0 on success.
static int decode_jpeg(FILE* f, uint8_t** out, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    uint8_t* buf = nullptr;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        free(buf);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const int W = cinfo.output_width, H = cinfo.output_height;
    buf = static_cast<uint8_t*>(malloc(size_t(W) * H * 3));
    if (!buf) longjmp(jerr.jb, 1);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = buf + size_t(cinfo.output_scanline) * W * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *out = buf;
    *w = W;
    *h = H;
    return 0;
}

// decode PNG file -> RGB8 (malloc'd). returns 0 on success.
static int decode_png(FILE* f, uint8_t** out, int* w, int* h) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) return -1;
    png_infop info = png_create_info_struct(png);
    uint8_t* buf = nullptr;
    if (!info || setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        free(buf);
        return -1;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    // normalize anything to 8-bit RGB
    png_set_strip_16(png);
    png_set_palette_to_rgb(png);
    png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    png_set_strip_alpha(png);
    png_set_gray_to_rgb(png);
    png_read_update_info(png, info);
    const int W = png_get_image_width(png, info);
    const int H = png_get_image_height(png, info);
    buf = static_cast<uint8_t*>(malloc(size_t(W) * H * 3));
    if (!buf) longjmp(png_jmpbuf(png), 1);
    std::vector<png_bytep> rows(H);
    for (int y = 0; y < H; y++) rows[y] = buf + size_t(y) * W * 3;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    *out = buf;
    *w = W;
    *h = H;
    return 0;
}

// decode by magic bytes -> RGB8. returns 0 on success.
int nio_load_rgb(const char* path, uint8_t** out, int* w, int* h) {
    FILE* f = fopen(path, "rb");
    if (!f) return -2;
    uint8_t magic[8] = {0};
    size_t n = fread(magic, 1, 8, f);
    rewind(f);
    int rc = -3;
    if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8)
        rc = decode_jpeg(f, out, w, h);
    else if (n >= 8 && magic[0] == 0x89 && magic[1] == 'P')
        rc = decode_png(f, out, w, h);
    fclose(f);
    return rc;
}

// decode + convert to float32, gray (ITU-R 601: the reference's cvtColor
// weights) or RGB. returns 0 on success.
int nio_load_f32(const char* path, float** out, int* w, int* h, int gray) {
    uint8_t* rgb = nullptr;
    int rc = nio_load_rgb(path, &rgb, w, h);
    if (rc) return rc;
    const size_t npx = size_t(*w) * size_t(*h);
    if (gray) {
        float* g = static_cast<float*>(malloc(npx * sizeof(float)));
        for (size_t i = 0; i < npx; i++) {
            const uint8_t* p = rgb + i * 3;
            g[i] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
        }
        *out = g;
    } else {
        float* c = static_cast<float*>(malloc(npx * 3 * sizeof(float)));
        for (size_t i = 0; i < npx * 3; i++) c[i] = float(rgb[i]);
        *out = c;
    }
    free(rgb);
    return 0;
}

void nio_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// prefetcher: worker threads decoding ahead of the consumer
// ---------------------------------------------------------------------------

struct Job {
    std::string path;
    int gray = 0;
    int ticket = 0;
};

struct Result {
    float* data = nullptr;
    int w = 0, h = 0, c = 0;
    int rc = -1;
};

struct Prefetcher {
    std::vector<std::thread> workers;
    std::deque<Job> queue;
    std::unordered_map<int, Result> done;
    std::mutex mu;
    std::condition_variable cv_job, cv_done;
    std::atomic<int> next_ticket{1};
    bool stopping = false;

    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_job.wait(lk, [&] { return stopping || !queue.empty(); });
                if (stopping && queue.empty()) return;
                job = std::move(queue.front());
                queue.pop_front();
            }
            Result r;
            r.c = job.gray ? 1 : 3;
            r.rc = nio_load_f32(job.path.c_str(), &r.data, &r.w, &r.h,
                                job.gray);
            {
                std::lock_guard<std::mutex> lk(mu);
                done[job.ticket] = r;
            }
            cv_done.notify_all();
        }
    }
};

void* pf_create(int n_threads) {
    auto* pf = new Prefetcher();
    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; i++)
        pf->workers.emplace_back([pf] { pf->run(); });
    return pf;
}

int pf_submit(void* h, const char* path, int gray) {
    auto* pf = static_cast<Prefetcher*>(h);
    int t = pf->next_ticket.fetch_add(1);
    {
        std::lock_guard<std::mutex> lk(pf->mu);
        pf->queue.push_back(Job{path, gray, t});
    }
    pf->cv_job.notify_one();
    return t;
}

// blocks until the ticket's decode finished; transfers buffer ownership.
int pf_wait(void* h, int ticket, float** data, int* w, int* hh, int* c) {
    auto* pf = static_cast<Prefetcher*>(h);
    std::unique_lock<std::mutex> lk(pf->mu);
    pf->cv_done.wait(lk, [&] { return pf->done.count(ticket) > 0; });
    Result r = pf->done[ticket];
    pf->done.erase(ticket);
    *data = r.data;
    *w = r.w;
    *hh = r.h;
    *c = r.c;
    return r.rc;
}

void pf_destroy(void* h) {
    auto* pf = static_cast<Prefetcher*>(h);
    {
        std::lock_guard<std::mutex> lk(pf->mu);
        pf->stopping = true;
    }
    pf->cv_job.notify_all();
    for (auto& t : pf->workers) t.join();
    for (auto& kv : pf->done) free(kv.second.data);
    delete pf;
}

// ---------------------------------------------------------------------------
// PNG encoder + async writer: result.png and the geo-tile pyramid are
// hundreds of 256^2 tiles at the end of a run; encode+fwrite happens on a
// writer thread with the GIL released (the Python side only memcpy's).
// ---------------------------------------------------------------------------

int nio_save_png(const char* path, const uint8_t* data, int w, int h,
                 int c) {
    if (c != 1 && c != 3) return -4;
    FILE* f = fopen(path, "wb");
    if (!f) return -2;
    // constructed BEFORE setjmp: a libpng longjmp must not skip a live
    // non-trivial object's destructor (UB + leak per failed write)
    std::vector<png_bytep> rows(static_cast<size_t>(h), nullptr);
    png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING,
                                              nullptr, nullptr, nullptr);
    png_infop info = png ? png_create_info_struct(png) : nullptr;
    if (!png || !info || setjmp(png_jmpbuf(png))) {
        if (png) png_destroy_write_struct(&png, info ? &info : nullptr);
        fclose(f);
        return -3;
    }
    png_init_io(png, f);
    png_set_IHDR(png, info, w, h, 8,
                 c == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB,
                 PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
                 PNG_FILTER_TYPE_DEFAULT);
    // speed over ratio: these are intermediate artifacts
    png_set_compression_level(png, 2);
    png_write_info(png, info);
    for (int y = 0; y < h; y++)
        rows[y] = const_cast<png_bytep>(data + size_t(y) * w * c);
    png_write_image(png, rows.data());
    png_write_end(png, nullptr);
    png_destroy_write_struct(&png, &info);
    fclose(f);
    return 0;
}

struct WriteJob {
    std::string path;
    std::vector<uint8_t> data;
    int w = 0, h = 0, c = 0;
};

struct Writer {
    std::thread worker;
    std::deque<WriteJob> queue;
    std::mutex mu;
    std::condition_variable cv_job, cv_idle;
    int inflight = 0;
    std::atomic<int> errors{0};
    bool stopping = false;

    void run() {
        for (;;) {
            WriteJob job;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_job.wait(lk, [&] { return stopping || !queue.empty(); });
                if (queue.empty()) {
                    if (stopping) return;
                    continue;
                }
                job = std::move(queue.front());
                queue.pop_front();
            }
            if (nio_save_png(job.path.c_str(), job.data.data(), job.w,
                             job.h, job.c) != 0)
                errors.fetch_add(1);
            {
                std::lock_guard<std::mutex> lk(mu);
                inflight--;
            }
            cv_idle.notify_all();
        }
    }
};

static Writer* g_writer = nullptr;
static std::mutex g_writer_mu;

int nio_save_png_async(const char* path, const uint8_t* data, int w,
                       int h, int c) {
    if (c != 1 && c != 3) return -4;
    {
        std::lock_guard<std::mutex> lk(g_writer_mu);
        if (!g_writer) {
            g_writer = new Writer();
            g_writer->worker = std::thread([] { g_writer->run(); });
            g_writer->worker.detach();
        }
    }
    WriteJob job;
    job.path = path;
    job.data.assign(data, data + size_t(w) * h * c);
    job.w = w; job.h = h; job.c = c;
    {
        std::lock_guard<std::mutex> lk(g_writer->mu);
        g_writer->queue.push_back(std::move(job));
        g_writer->inflight++;
    }
    g_writer->cv_job.notify_one();
    return 0;
}

// wait for all queued writes; returns the number of failed writes since
// the last flush
int nio_save_flush() {
    std::lock_guard<std::mutex> glk(g_writer_mu);
    if (!g_writer) return 0;
    std::unique_lock<std::mutex> lk(g_writer->mu);
    g_writer->cv_idle.wait(lk, [&] {
        return g_writer->inflight == 0 && g_writer->queue.empty();
    });
    return g_writer->errors.exchange(0);
}

}  // extern "C"
