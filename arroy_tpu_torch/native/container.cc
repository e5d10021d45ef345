// arroy-tpu native storage container.
//
// Plays the role LMDB plays for the reference (reference: src/lib.rs:1-3 —
// a memory-mapped store shared between processes, with atomic publication):
// one self-describing file per index generation, holding all array blobs.
//
// Responsibilities kept native for throughput and durability:
//   * threaded pwrite() of blob payloads (saturates NVMe on multi-GB indexes)
//   * crc32 (slice-by-8) integrity checks per blob
//   * fsync + atomic rename publication (crash => previous generation intact)
//   * mmap(PROT_READ) + madvise open so readers share pages across processes
//     and only fault in what they touch (the LMDB zero-copy property)
//
// File layout:
//   [0..8)   magic "ARROYTPC"
//   [8..16)  u64 header_len (JSON, UTF-8)
//   [16..16+header_len) header JSON: {"blobs": [{name,dtype,shape,offset,
//                                               nbytes,crc32}...]}
//   payload blobs, each 64-byte aligned.
//
// Exposed as a tiny C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <string>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>
#include <atomic>

namespace {

uint32_t crc_table[8][256];
std::atomic<bool> crc_init_done{false};

void crc_init() {
  bool expected = false;
  static std::atomic<bool> started{false};
  if (crc_init_done.load(std::memory_order_acquire)) return;
  if (started.compare_exchange_strong(expected, true)) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (-(c & 1)));
      crc_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int t = 1; t < 8; t++)
        crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^
                          crc_table[0][crc_table[t - 1][i] & 0xFF];
    crc_init_done.store(true, std::memory_order_release);
  } else {
    while (!crc_init_done.load(std::memory_order_acquire)) {}
  }
}

uint32_t crc32_slice8(const uint8_t* p, uint64_t n, uint32_t crc = 0) {
  crc_init();
  crc = ~crc;
  while (n >= 8) {
    uint32_t one;
    uint32_t two;
    std::memcpy(&one, p, 4);
    std::memcpy(&two, p + 4, 4);
    one ^= crc;
    crc = crc_table[7][one & 0xFF] ^ crc_table[6][(one >> 8) & 0xFF] ^
          crc_table[5][(one >> 16) & 0xFF] ^ crc_table[4][one >> 24] ^
          crc_table[3][two & 0xFF] ^ crc_table[2][(two >> 8) & 0xFF] ^
          crc_table[1][(two >> 16) & 0xFF] ^ crc_table[0][two >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ crc_table[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

bool pwrite_all(int fd, const void* buf, uint64_t n, uint64_t off) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t w = pwrite(fd, p, n, static_cast<off_t>(off));
    if (w <= 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    off += static_cast<uint64_t>(w);
    n -= static_cast<uint64_t>(w);
  }
  return true;
}

}  // namespace

extern "C" {

// crc of a buffer — used by the python side to fill the header.
uint32_t atc_crc32(const void* buf, uint64_t n) {
  return crc32_slice8(static_cast<const uint8_t*>(buf), n);
}

// Write header + blobs to `tmp_path`, fsync, rename to `path`.
// offsets[] are absolute file offsets for each blob (python computes the
// aligned layout and embeds it in the header JSON it passes here).
// n_threads <= 0 picks hardware_concurrency.  Returns 0 on success.
int atc_write(const char* path, const char* tmp_path, const void* header,
              uint64_t header_len, uint64_t n_blobs, const void* const* blobs,
              const uint64_t* sizes, const uint64_t* offsets, int n_threads) {
  int fd = open(tmp_path, O_CREAT | O_TRUNC | O_WRONLY | O_CLOEXEC, 0644);
  if (fd < 0) return -1;

  char magic[8] = {'A', 'R', 'R', 'O', 'Y', 'T', 'P', 'C'};
  uint64_t hlen = header_len;
  if (!pwrite_all(fd, magic, 8, 0) || !pwrite_all(fd, &hlen, 8, 8) ||
      !pwrite_all(fd, header, header_len, 16)) {
    close(fd);
    return -2;
  }

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  std::atomic<uint64_t> next{0};
  std::atomic<int> err{0};
  auto worker = [&]() {
    for (;;) {
      uint64_t i = next.fetch_add(1);
      if (i >= n_blobs || err.load()) break;
      if (!pwrite_all(fd, blobs[i], sizes[i], offsets[i])) err.store(-3);
    }
  };
  std::vector<std::thread> ts;
  int nt = n_blobs < static_cast<uint64_t>(n_threads)
               ? static_cast<int>(n_blobs)
               : n_threads;
  for (int t = 1; t < nt; t++) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
  if (err.load()) {
    close(fd);
    return err.load();
  }

  if (fsync(fd) != 0) {
    close(fd);
    return -4;
  }
  close(fd);
  if (rename(tmp_path, path) != 0) return -5;
  // durability of the rename itself: fsync the parent directory
  std::string dir(path);
  auto slash = dir.find_last_of('/');
  dir = (slash == std::string::npos) ? std::string(".") : dir.substr(0, slash);
  int dfd = open(dir.c_str(), O_RDONLY | O_DIRECTORY | O_CLOEXEC);
  if (dfd >= 0) {
    fsync(dfd);
    close(dfd);
  }
  return 0;
}

// mmap the whole file read-only.  Returns base pointer (or null), size via
// out param.  willneed!=0 prefetches the mapping.
void* atc_open(const char* path, uint64_t* out_size, int willneed) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                    MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  if (std::memcmp(base, "ARROYTPC", 8) != 0) {
    munmap(base, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  if (willneed) madvise(base, static_cast<size_t>(st.st_size), MADV_WILLNEED);
  *out_size = static_cast<uint64_t>(st.st_size);
  return base;
}

void atc_close(void* base, uint64_t size) {
  if (base) munmap(base, static_cast<size_t>(size));
}

}  // extern "C"
