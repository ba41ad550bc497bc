// Native LMDB read path of the dpmn_tpu_torch input pipeline: a copy of the
// JAX package's native/lmdb_reader.cpp (the port builds its own).
//
// The Python B-tree walk of data/lmdb_reader.py costs ~10us/get in
// struct.unpack overhead alone at TextZoom scale.  This reader mmaps the
// database once and serves GETs with zero copies until the caller
// materializes values.
//
// Format notes mirror the Python reader (see lmdb_reader.py docstring):
// meta pages 0/1 (pick the newer txn), branch pages with 48-bit child
// pgnos packed into (lo, hi, flags), leaf nodes with optional BIGDATA
// overflow pages.
//
// Built by g++ at first use into dpmn_tpu_torch/_build/ and bound with
// ctypes (data/native_lmdb.py).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint16_t kBranch = 0x01, kLeaf = 0x02, kMeta = 0x08;
constexpr uint16_t kBigData = 0x01;
constexpr size_t kHdr = 16;

struct Env {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  size_t psize = 4096;
  int64_t root = -1;
};

inline uint16_t rd16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

bool read_meta(Env* env) {
  const size_t sizes[] = {4096, 8192, 16384, 32768, 1024, 2048};
  uint64_t best_txn = 0;
  bool found = false;
  for (size_t ps : sizes) {
    for (int idx = 0; idx < 2; ++idx) {
      size_t off = idx * ps;
      if (off + kHdr + 160 > env->size) continue;
      const uint8_t* m = env->map + off + kHdr;
      if (rd32(m) != kMagic) continue;
      // meta: magic u32, version u32, address u64, mapsize u64,
      // MDB_db free(48), MDB_db main(48), last_pg u64, txnid u64
      const uint8_t* main_db = m + 8 + 8 + 8 + 48;
      int64_t root;
      std::memcpy(&root, main_db + 40, 8);
      uint64_t txn = rd64(m + 8 + 8 + 8 + 48 + 48 + 8);
      if (!found || txn > best_txn) {
        best_txn = txn;
        env->psize = ps;
        env->root = root;
        found = true;
      }
    }
    if (found) break;
  }
  return found;
}

// returns pointer+len of value, or nullptr
const uint8_t* env_get(const Env* env, const uint8_t* key, size_t klen, size_t* vlen) {
  int64_t pgno = env->root;
  if (pgno < 0) return nullptr;
  while (true) {
    const uint8_t* page = env->map + pgno * env->psize;
    uint16_t flags = rd16(page + 10);
    uint16_t lower = rd16(page + 12);
    int nkeys = (lower - kHdr) / 2;
    const uint8_t* ptrs = page + kHdr;
    if (flags & kBranch) {
      int lo = 1, hi = nkeys - 1, child = 0;
      while (lo <= hi) {
        int mid = (lo + hi) / 2;
        const uint8_t* node = page + rd16(ptrs + 2 * mid);
        uint16_t ks = rd16(node + 6);
        const uint8_t* k = node + 8;
        int c = std::memcmp(k, key, ks < klen ? ks : klen);
        bool le = c < 0 || (c == 0 && ks <= klen);
        if (le) { child = mid; lo = mid + 1; } else { hi = mid - 1; }
      }
      const uint8_t* node = page + rd16(ptrs + 2 * child);
      pgno = (int64_t)rd16(node) | ((int64_t)rd16(node + 2) << 16) |
             ((int64_t)rd16(node + 4) << 32);
    } else if (flags & kLeaf) {
      int lo = 0, hi = nkeys - 1;
      while (lo <= hi) {
        int mid = (lo + hi) / 2;
        const uint8_t* node = page + rd16(ptrs + 2 * mid);
        uint32_t vsz = (uint32_t)rd16(node) | ((uint32_t)rd16(node + 2) << 16);
        uint16_t nflags = rd16(node + 4);
        uint16_t ks = rd16(node + 6);
        const uint8_t* k = node + 8;
        int c = std::memcmp(k, key, ks < klen ? ks : klen);
        if (c == 0 && ks == klen) {
          *vlen = vsz;
          if (nflags & kBigData) {
            uint64_t ov = rd64(node + 8 + ks);
            return env->map + ov * env->psize + kHdr;
          }
          return node + 8 + ks;
        }
        bool lt = c < 0 || (c == 0 && ks < klen);
        if (lt) lo = mid + 1; else hi = mid - 1;
      }
      return nullptr;
    } else {
      return nullptr;
    }
  }
}

}  // namespace

extern "C" {

void* lmdb_open(const char* path) {
  Env* env = new Env();
  env->fd = ::open(path, O_RDONLY);
  if (env->fd < 0) { delete env; return nullptr; }
  struct stat st;
  if (fstat(env->fd, &st) != 0) { ::close(env->fd); delete env; return nullptr; }
  env->size = (size_t)st.st_size;
  env->map = (const uint8_t*)mmap(nullptr, env->size, PROT_READ, MAP_SHARED, env->fd, 0);
  if (env->map == MAP_FAILED || !read_meta(env)) {
    if (env->map != MAP_FAILED) munmap((void*)env->map, env->size);
    ::close(env->fd);
    delete env;
    return nullptr;
  }
  return env;
}

void lmdb_close(void* handle) {
  Env* env = (Env*)handle;
  if (!env) return;
  munmap((void*)env->map, env->size);
  ::close(env->fd);
  delete env;
}

// single get: returns value length or -1; writes up to cap bytes into out
long lmdb_get(void* handle, const uint8_t* key, long klen, uint8_t* out, long cap) {
  size_t vlen = 0;
  const uint8_t* v = env_get((const Env*)handle, key, (size_t)klen, &vlen);
  if (!v) return -1;
  if (out && cap > 0) std::memcpy(out, v, vlen < (size_t)cap ? vlen : (size_t)cap);
  return (long)vlen;
}

}  // extern "C"
