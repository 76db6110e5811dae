// Threaded batch gatherer over a packed row-major uint8 store.
//
// The port's own copy of the JAX package's loader. After the one-time pack
// (data/threedident.py:pack_images) a batch of renders is a row gather from
// a memory-mapped .npy file; this does the gather with a few threads,
// releasing the GIL for the whole batch (ctypes calls drop it), so that the
// host-prefetch loader's workers gather while the card runs the step. The
// caller owns the output buffer, which may be a pinned tensor's memory.
//
// Beside the JAX copy: the table of open stores is guarded by a mutex (the
// loader's worker threads gather while the evaluation opens or gathers),
// and the caller chooses the number of threads a gather uses.
//
// C ABI (ctypes):
//   pl_open(path, row_bytes, n_rows) -> handle (or -1)
//   pl_gather(handle, idx_i64, count, out_u8, n_threads) -> 0, -1 (bad
//       handle) or -2 (an index out of range; its row is left unwritten);
//       n_threads 0 means one a core
//   pl_close(handle)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Store {
    const uint8_t* base = nullptr;  // first row (past npy header)
    size_t row_bytes = 0;
    int64_t n_rows = 0;
    void* map = nullptr;
    size_t map_len = 0;
    int fd = -1;
};

std::mutex g_mutex;
std::vector<Store*> g_stores;

Store* find(int64_t handle) {
    std::lock_guard<std::mutex> hold(g_mutex);
    if (handle < 0 || handle >= static_cast<int64_t>(g_stores.size())) return nullptr;
    return g_stores[handle];
}

size_t npy_header_len(const uint8_t* p, size_t len) {
    // \x93NUMPY major minor hlen(2 or 4 LE)
    if (len < 10 || p[0] != 0x93) return 0;
    uint8_t major = p[6];
    if (major >= 2) {
        uint32_t h;
        std::memcpy(&h, p + 8, 4);
        return 12 + h;
    }
    uint16_t h;
    std::memcpy(&h, p + 8, 2);
    return 10 + h;
}

}  // namespace

extern "C" {

int64_t pl_open(const char* path, int64_t row_bytes, int64_t n_rows) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return -1; }
    void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    if (map == MAP_FAILED) { ::close(fd); return -1; }
    madvise(map, st.st_size, MADV_RANDOM);
    auto* s = new Store();
    s->fd = fd;
    s->map = map;
    s->map_len = st.st_size;
    size_t header = npy_header_len(static_cast<const uint8_t*>(map), st.st_size);
    s->base = static_cast<const uint8_t*>(map) + header;
    s->row_bytes = static_cast<size_t>(row_bytes);
    s->n_rows = n_rows;
    if (header + row_bytes * n_rows > static_cast<size_t>(st.st_size)) {
        munmap(map, st.st_size);
        ::close(fd);
        delete s;
        return -1;
    }
    std::lock_guard<std::mutex> hold(g_mutex);
    g_stores.push_back(s);
    return static_cast<int64_t>(g_stores.size() - 1);
}

int pl_gather(int64_t handle, const int64_t* idx, int64_t count, uint8_t* out,
              int n_threads_wanted) {
    Store* s = find(handle);
    if (s == nullptr) return -1;
    const size_t rb = s->row_bytes;

    unsigned n_threads = n_threads_wanted > 0
        ? static_cast<unsigned>(n_threads_wanted) : std::thread::hardware_concurrency();
    if (n_threads == 0) n_threads = 1;
    if (static_cast<int64_t>(n_threads) > count) n_threads = count;

    std::atomic<int> bad{0};
    auto worker = [&](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
            int64_t r = idx[i];
            if (r < 0 || r >= s->n_rows) { bad.store(1); continue; }
            std::memcpy(out + i * rb, s->base + r * rb, rb);
        }
    };
    if (n_threads <= 1) {
        worker(0, count);
    } else {
        std::vector<std::thread> threads;
        int64_t chunk = (count + n_threads - 1) / n_threads;
        for (unsigned t = 0; t < n_threads; ++t) {
            int64_t b = t * chunk;
            int64_t e = b + chunk < count ? b + chunk : count;
            if (b >= e) break;
            threads.emplace_back(worker, b, e);
        }
        for (auto& th : threads) th.join();
    }
    return bad.load() ? -2 : 0;
}

void pl_close(int64_t handle) {
    Store* s = nullptr;
    {
        std::lock_guard<std::mutex> hold(g_mutex);
        if (handle < 0 || handle >= static_cast<int64_t>(g_stores.size())) return;
        s = g_stores[handle];
        g_stores[handle] = nullptr;
    }
    if (!s) return;
    munmap(s->map, s->map_len);
    ::close(s->fd);
    delete s;
}

}  // extern "C"
