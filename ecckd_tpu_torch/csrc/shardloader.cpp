// shardloader.cpp - native loader for the flat binary spectral shards
//
// The port's own copy of the JAX package's csrc/shardloader.cpp (the port
// builds nothing from outside its package).  create_lut, lw_spectra and
// the other spectrum readers stream one profile's optical depth in
// wavenumber blocks; at CKDMIP scale (~5.6M wavenumbers x 50 layers a
// profile) reading them from disk is a large share of the wall clock
// (doc/ecckd_documentation.tex:225-228).  This library gives those readers
// synchronous and pooled asynchronous pread-based reads of `.spbin` shards,
// so the next block is read while the card averages the current one.
//
// A plain C ABI consumed from Python via ctypes
// (ecckd_tpu_torch/io/native.py, which builds it with g++ at first use).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct File {
    int fd = -1;
    int64_t size = 0;
};

struct Request {
    int tag = 0;
    File* file = nullptr;
    int64_t offset = 0;
    int64_t size = 0;
};

struct Completion {
    std::vector<char> data;
    int64_t size = 0;      // bytes actually read; < 0 on error
};

// Thread pool with a bounded number of in-flight buffers; completions are
// retrieved by tag so Python can pipeline: submit(chunk k+1) -> wait(k).
struct Pool {
    explicit Pool(int nthreads) : stop(false) {
        for (int i = 0; i < nthreads; ++i) {
            workers.emplace_back([this] { run(); });
        }
    }

    ~Pool() {
        {
            std::unique_lock<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& t : workers) t.join();
    }

    void submit(const Request& req) {
        {
            std::unique_lock<std::mutex> lk(mu);
            queue.push_back(req);
        }
        cv.notify_one();
    }

    // Blocks until the request with this tag completes; the completion stays
    // owned by the pool until release().
    Completion* wait(int tag) {
        std::unique_lock<std::mutex> lk(mu);
        done_cv.wait(lk, [&] { return done.count(tag) > 0; });
        return &done[tag];
    }

    void release(int tag) {
        std::unique_lock<std::mutex> lk(mu);
        done.erase(tag);
    }

  private:
    void run() {
        for (;;) {
            Request req;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [&] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                req = queue.front();
                queue.pop_front();
            }
            Completion comp;
            comp.data.resize(req.size);
            int64_t total = 0;
            while (total < req.size) {
                ssize_t n = pread(req.file->fd, comp.data.data() + total,
                                  req.size - total, req.offset + total);
                if (n < 0) {
                    total = -1;
                    break;
                }
                if (n == 0) break;   // EOF
                total += n;
            }
            comp.size = total;
            {
                std::unique_lock<std::mutex> lk(mu);
                done[req.tag] = std::move(comp);
            }
            done_cv.notify_all();
        }
    }

    std::vector<std::thread> workers;
    std::deque<Request> queue;
    std::unordered_map<int, Completion> done;
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    bool stop;
};

}   // namespace

extern "C" {

void* sl_open(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
#ifdef POSIX_FADV_SEQUENTIAL
    posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return nullptr;
    }
    File* f = new File;
    f->fd = fd;
    f->size = st.st_size;
    return f;
}

int64_t sl_size(void* handle) {
    return handle ? static_cast<File*>(handle)->size : -1;
}

// Synchronous read into a caller buffer; returns bytes read or -1.
int64_t sl_read(void* handle, int64_t offset, int64_t size, void* dst) {
    if (!handle) return -1;
    File* f = static_cast<File*>(handle);
    int64_t total = 0;
    char* out = static_cast<char*>(dst);
    while (total < size) {
        ssize_t n = pread(f->fd, out + total, size - total, offset + total);
        if (n < 0) return -1;
        if (n == 0) break;
        total += n;
    }
    return total;
}

void sl_close(void* handle) {
    if (!handle) return;
    File* f = static_cast<File*>(handle);
    close(f->fd);
    delete f;
}

void* sl_pool_create(int nthreads) {
    if (nthreads < 1) nthreads = 1;
    return new Pool(nthreads);
}

void sl_pool_destroy(void* pool) {
    delete static_cast<Pool*>(pool);
}

// Submit an async read; the tag identifies it for sl_pool_wait.
int sl_pool_submit(void* pool, void* file, int64_t offset, int64_t size,
                   int tag) {
    if (!pool || !file || size < 0) return -1;
    Request req;
    req.tag = tag;
    req.file = static_cast<File*>(file);
    req.offset = offset;
    req.size = size;
    static_cast<Pool*>(pool)->submit(req);
    return 0;
}

// Block until tag completes; copies the data into dst (capacity bytes) and
// releases the internal buffer.  Returns bytes read or -1.
int64_t sl_pool_wait(void* pool, int tag, void* dst, int64_t capacity) {
    if (!pool) return -1;
    Pool* p = static_cast<Pool*>(pool);
    Completion* comp = p->wait(tag);
    int64_t n = comp->size;
    if (n > 0) {
        if (n > capacity) n = -1;
        else memcpy(dst, comp->data.data(), n);
    }
    p->release(tag);
    return n;
}

}   // extern "C"
