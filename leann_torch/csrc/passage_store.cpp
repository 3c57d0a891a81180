// Native passage store: an mmap'd jsonl and a binary offset index — host core.
//
// A copy of the JAX package's native store (csrc/passage_store.cpp), so that
// a .cidx written by either package opens in the other. Two jobs:
//
//   1. ps_build_index: a single pass over a .jsonl file, keeping each line's
//      "id" field and byte offset in a compact binary index.
//   2. ps_open/ps_get: mmap the jsonl and answer id -> (ptr, len) lookups
//      from an in-memory hash map with zero copies.
//
// Binary index format (.cidx): magic "LPSX" u32 | version u32 | count u64 |
// count * { u64 offset, u32 id_len, id bytes } .
//
// C ABI for ctypes; no dependencies beyond the C++ standard library. Built
// with the host compiler by leann_torch/ops/cuda_build.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x5853504C;  // "LPSX" little-endian
constexpr uint32_t kVersion = 1;

struct Store {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  std::unordered_map<std::string, std::pair<uint64_t, uint32_t>> index;  // id -> (offset, line_len)
};

// Extract the value of "id" from a JSON line. Handles string and integer ids;
// the builder always writes {"id": "...", ...} first but we scan anywhere in
// the line to be safe.
bool extract_id(const char* line, size_t len, std::string* out) {
  static const char kKey[] = "\"id\"";
  const char* p = static_cast<const char*>(memmem(line, len, kKey, 4));
  if (!p) return false;
  p += 4;
  const char* end = line + len;
  while (p < end && (*p == ' ' || *p == ':')) ++p;
  if (p >= end) return false;
  if (*p == '"') {
    ++p;
    std::string s;
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) {
        ++p;
        switch (*p) {
          case 'n': s += '\n'; break;
          case 't': s += '\t'; break;
          case 'r': s += '\r'; break;
          default: s += *p;
        }
      } else {
        s += *p;
      }
      ++p;
    }
    *out = std::move(s);
    return true;
  }
  // numeric id
  const char* q = p;
  while (q < end && ((*q >= '0' && *q <= '9') || *q == '-')) ++q;
  if (q == p) return false;
  out->assign(p, q - p);
  return true;
}

}  // namespace

extern "C" {

// Scan jsonl, write binary offset index. Returns number of passages, or -1.
long long ps_build_index(const char* jsonl_path, const char* idx_path) {
  FILE* in = fopen(jsonl_path, "rb");
  if (!in) return -1;
  FILE* out = fopen(idx_path, "wb");
  if (!out) {
    fclose(in);
    return -1;
  }
  uint64_t count = 0;
  fwrite(&kMagic, 4, 1, out);
  fwrite(&kVersion, 4, 1, out);
  long count_pos = ftell(out);
  fwrite(&count, 8, 1, out);

  std::vector<char> buf(1 << 20);
  uint64_t offset = 0;
  std::string line;
  line.reserve(1 << 16);
  size_t nread;
  uint64_t line_start = 0;
  while ((nread = fread(buf.data(), 1, buf.size(), in)) > 0) {
    size_t pos = 0;
    while (pos < nread) {
      const char* nl = static_cast<const char*>(memchr(buf.data() + pos, '\n', nread - pos));
      size_t take = nl ? (nl - (buf.data() + pos)) : (nread - pos);
      line.append(buf.data() + pos, take);
      pos += take;
      if (nl) {
        ++pos;  // consume '\n'
        if (!line.empty()) {
          std::string id;
          if (extract_id(line.data(), line.size(), &id)) {
            uint32_t id_len = static_cast<uint32_t>(id.size());
            fwrite(&line_start, 8, 1, out);
            fwrite(&id_len, 4, 1, out);
            fwrite(id.data(), 1, id_len, out);
            ++count;
          }
        }
        line_start = offset + pos;
        line.clear();
      }
    }
    offset += nread;
  }
  fclose(in);
  fseek(out, count_pos, SEEK_SET);
  fwrite(&count, 8, 1, out);
  fclose(out);
  return static_cast<long long>(count);
}

// Open store: mmap jsonl, load binary index. Returns opaque handle or null.
void* ps_open(const char* jsonl_path, const char* idx_path) {
  FILE* idx = fopen(idx_path, "rb");
  if (!idx) return nullptr;
  uint32_t magic = 0, version = 0;
  uint64_t count = 0;
  if (fread(&magic, 4, 1, idx) != 1 || magic != kMagic ||
      fread(&version, 4, 1, idx) != 1 || version != kVersion ||
      fread(&count, 8, 1, idx) != 1) {
    fclose(idx);
    return nullptr;
  }
  auto* store = new Store();
  store->index.reserve(count);
  std::string id;
  for (uint64_t i = 0; i < count; ++i) {
    uint64_t off;
    uint32_t id_len;
    if (fread(&off, 8, 1, idx) != 1 || fread(&id_len, 4, 1, idx) != 1) break;
    id.resize(id_len);
    if (id_len && fread(&id[0], 1, id_len, idx) != id_len) break;
    store->index.emplace(id, std::make_pair(off, 0u));
  }
  fclose(idx);

  store->fd = open(jsonl_path, O_RDONLY);
  if (store->fd < 0) {
    delete store;
    return nullptr;
  }
  struct stat st;
  fstat(store->fd, &st);
  store->size = static_cast<size_t>(st.st_size);
  store->data = static_cast<const char*>(
      mmap(nullptr, store->size, PROT_READ, MAP_PRIVATE, store->fd, 0));
  if (store->data == MAP_FAILED) {
    close(store->fd);
    delete store;
    return nullptr;
  }
  return store;
}

long long ps_count(void* handle) {
  return static_cast<Store*>(handle)->index.size();
}

// id -> pointer to the jsonl line (zero-copy into the mmap). Returns line
// length, 0 if missing.
uint64_t ps_get(void* handle, const char* id, const char** out_ptr) {
  auto* store = static_cast<Store*>(handle);
  auto it = store->index.find(id);
  if (it == store->index.end()) return 0;
  uint64_t off = it->second.first;
  if (off >= store->size) return 0;
  const char* start = store->data + off;
  const char* nl = static_cast<const char*>(
      memchr(start, '\n', store->size - off));
  *out_ptr = start;
  return nl ? static_cast<uint64_t>(nl - start) : (store->size - off);
}

void ps_close(void* handle) {
  auto* store = static_cast<Store*>(handle);
  if (store->data && store->data != MAP_FAILED) munmap(const_cast<char*>(store->data), store->size);
  if (store->fd >= 0) close(store->fd);
  delete store;
}

}  // extern "C"
