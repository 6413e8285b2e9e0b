// Native .pack store reader — mmap-based random access (see
// deepclr_tpu_torch/data/pack.py for the format; the port's own copy of
// native/pack_reader.cpp).  The runtime data path uses this
// through ctypes for zero-copy record access; a standalone `pack_info` CLI
// doubles as a store inspector.
//
// Exported C ABI:
//   void*  pack_open(const char* path);
//   long   pack_count(void* handle);
//   long   pack_key(void* handle, long i, char* buf, long buflen);
//   long   pack_get(void* handle, const char* key, const unsigned char** data);
//   void   pack_close(void* handle);
//
// Build: g++ -O3 -std=c++17 -shared -fPIC pack_reader.cpp -o libpack_reader.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr char kMagic[8] = {'D', 'C', 'L', 'R', 'P', 'A', 'K', '1'};

struct Pack {
  int fd = -1;
  const unsigned char *data = nullptr;
  size_t size = 0;
  std::vector<std::string> keys;                       // sorted
  std::map<std::string, std::pair<uint64_t, uint64_t>> index;  // key -> (off,len)
};

template <typename T>
T read_le(const unsigned char *p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;  // little-endian hosts only (x86/arm64)
}

}  // namespace

extern "C" {

void *pack_open(const char *path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 32) {
    ::close(fd);
    return nullptr;
  }
  auto size = static_cast<size_t>(st.st_size);
  auto *data = static_cast<const unsigned char *>(
      ::mmap(nullptr, size, PROT_READ, MAP_SHARED, fd, 0));
  if (data == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  if (std::memcmp(data, kMagic, 8) != 0 ||
      std::memcmp(data + size - 8, kMagic, 8) != 0) {
    ::munmap(const_cast<unsigned char *>(data), size);
    ::close(fd);
    return nullptr;
  }

  auto *pack = new Pack();
  pack->fd = fd;
  pack->data = data;
  pack->size = size;

  uint64_t index_offset = read_le<uint64_t>(data + size - 16);
  uint64_t n = read_le<uint64_t>(data + index_offset);
  size_t pos = index_offset + 8;
  for (uint64_t i = 0; i < n; ++i) {
    uint16_t klen = read_le<uint16_t>(data + pos);
    pos += 2;
    std::string key(reinterpret_cast<const char *>(data + pos), klen);
    pos += klen;
    uint64_t off = read_le<uint64_t>(data + pos);
    uint64_t len = read_le<uint64_t>(data + pos + 8);
    pos += 16;
    pack->index[key] = {off, len};
  }
  for (const auto &kv : pack->index) pack->keys.push_back(kv.first);
  return pack;
}

long pack_count(void *handle) {
  if (!handle) return -1;
  return static_cast<long>(static_cast<Pack *>(handle)->keys.size());
}

long pack_key(void *handle, long i, char *buf, long buflen) {
  auto *pack = static_cast<Pack *>(handle);
  if (!pack || i < 0 || static_cast<size_t>(i) >= pack->keys.size()) return -1;
  const std::string &k = pack->keys[i];
  long n = std::min<long>(buflen - 1, static_cast<long>(k.size()));
  std::memcpy(buf, k.data(), n);
  buf[n] = '\0';
  return static_cast<long>(k.size());
}

long pack_get(void *handle, const char *key, const unsigned char **out) {
  auto *pack = static_cast<Pack *>(handle);
  if (!pack) return -1;
  auto it = pack->index.find(key);
  if (it == pack->index.end()) return -1;
  *out = pack->data + it->second.first;
  return static_cast<long>(it->second.second);
}

void pack_close(void *handle) {
  auto *pack = static_cast<Pack *>(handle);
  if (!pack) return;
  ::munmap(const_cast<unsigned char *>(pack->data), pack->size);
  ::close(pack->fd);
  delete pack;
}

}  // extern "C"

#ifdef PACK_READER_MAIN
#include <cstdio>
int main(int argc, char **argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: pack_info FILE.pack\n");
    return 1;
  }
  void *h = pack_open(argv[1]);
  if (!h) {
    std::fprintf(stderr, "not a pack file: %s\n", argv[1]);
    return 1;
  }
  long n = pack_count(h);
  std::printf("%s: %ld records\n", argv[1], n);
  char buf[256];
  for (long i = 0; i < std::min(n, 5L); ++i) {
    pack_key(h, i, buf, sizeof(buf));
    const unsigned char *data;
    long len = pack_get(h, buf, &data);
    std::printf("  %s: %ld bytes\n", buf, len);
  }
  pack_close(h);
  return 0;
}
#endif
