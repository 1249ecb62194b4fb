// Native I/O engine: threaded field writer/reader for checkpoints and
// visualization dumps.
//
// Native counterpart of the reference's collective MPI-IO path
// (/root/reference/src/load.f90:155-187): there, ranks cooperate on one file
// via subarray views; here, a single host process drains device-to-host field
// buffers to disk with N pwrite() worker threads over disjoint stripes, which
// saturates local NVMe/overlayfs far better than a single fwrite loop.
//
// C ABI (used from Python via ctypes, no pybind11 dependency):
//   ce_open(path, for_write)            -> fd (or -errno)
//   ce_pwrite_threaded(fd, buf, n, off, nthreads) -> 0 / -errno
//   ce_pread_threaded (fd, buf, n, off, nthreads) -> 0 / -errno
//   ce_truncate(fd, size)               -> 0 / -errno
//   ce_close(fd)
//   ce_version()                        -> ABI version int

#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int kAbiVersion = 1;

// stripe a [0, n) byte range over nthreads contiguous chunks
struct Stripe {
  size_t off;
  size_t len;
};

std::vector<Stripe> make_stripes(size_t n, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  size_t chunk = (n + nthreads - 1) / nthreads;
  // keep chunks page-aligned for better write clustering
  constexpr size_t kAlign = 1 << 20;  // 1 MiB
  if (chunk > kAlign) chunk = (chunk + kAlign - 1) / kAlign * kAlign;
  std::vector<Stripe> out;
  for (size_t off = 0; off < n; off += chunk) {
    out.push_back({off, off + chunk > n ? n - off : chunk});
  }
  return out;
}

int io_threaded(bool write, int fd, void* buf, size_t n, size_t file_off,
                int nthreads) {
  auto stripes = make_stripes(n, nthreads);
  std::vector<std::thread> workers;
  std::vector<int> errs(stripes.size(), 0);
  for (size_t s = 0; s < stripes.size(); ++s) {
    workers.emplace_back([&, s]() {
      char* p = static_cast<char*>(buf) + stripes[s].off;
      size_t left = stripes[s].len;
      off_t off = static_cast<off_t>(file_off + stripes[s].off);
      while (left > 0) {
        ssize_t r = write ? ::pwrite(fd, p, left, off)
                          : ::pread(fd, p, left, off);
        if (r < 0) {
          if (errno == EINTR) continue;
          errs[s] = errno;
          return;
        }
        if (r == 0) {  // unexpected EOF on read
          errs[s] = EIO;
          return;
        }
        p += r;
        off += r;
        left -= static_cast<size_t>(r);
      }
    });
  }
  for (auto& t : workers) t.join();
  for (int e : errs) {
    if (e) return -e;
  }
  return 0;
}

}  // namespace

extern "C" {

int ce_version() { return kAbiVersion; }

int ce_open(const char* path, int for_write) {
  int fd = for_write
               ? ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644)
               : ::open(path, O_RDONLY);
  return fd >= 0 ? fd : -errno;
}

int ce_pwrite_threaded(int fd, const void* buf, size_t n, size_t off,
                       int nthreads) {
  return io_threaded(true, fd, const_cast<void*>(buf), n, off, nthreads);
}

int ce_pread_threaded(int fd, void* buf, size_t n, size_t off, int nthreads) {
  return io_threaded(false, fd, buf, n, off, nthreads);
}

int ce_truncate(int fd, size_t size) {
  return ::ftruncate(fd, static_cast<off_t>(size)) == 0 ? 0 : -errno;
}

int ce_close(int fd) { return ::close(fd); }

}  // extern "C"
