// Native shard reader: mmap'd zero-copy access to exported .npz shards.
//
// Reference capability: the reference's data plane is native — DataVec's
// loaders and ND4J's IO run in C++ under the JVM (SURVEY.md §2.6 / §3 L3);
// its Spark workers stream exported batch files through that native path.
// Here the export-shard format (datasets/export.py: uncompressed .npz =
// zip of .npy members, np.savez) gets the same treatment: the zip central
// directory and the npy headers are parsed in C++, the file is mmap'd, and
// member bytes are served either zero-copy (pointer into the map) or by a
// GIL-free memcpy — the Python path (np.load) re-parses headers and copies
// through BufferedIO on every shard.
//
// Scope: STORED (method 0) zip members only — np.savez never compresses —
// classic (non-zip64) format, which covers shards to 4GB.
//
// Built with: g++ -O3 -shared -fPIC shard_reader.cpp -o libshard_reader.so
// Loaded via ctypes (deeplearning4j_tpu/native/__init__.py) — no pybind11.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Member {
  std::string name;
  std::string descr;        // npy dtype string, e.g. "<f4"
  int64_t shape[32];
  int ndim = 0;
  int fortran = 0;
  uint64_t data_off = 0;    // absolute offset of the array bytes
  uint64_t nbytes = 0;      // array payload size
};

struct Reader {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  std::vector<Member> members;
};

uint16_t rd16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }

// Parse one npy header at `off`; fills descr/shape/data offset. Returns
// false on malformed input.
bool parse_npy(const uint8_t* base, size_t limit, uint64_t off, Member* m) {
  static const uint8_t magic[6] = {0x93, 'N', 'U', 'M', 'P', 'Y'};
  if (off + 10 > limit || std::memcmp(base + off, magic, 6) != 0) return false;
  uint8_t major = base[off + 6];
  uint64_t hlen, hstart;
  if (major == 1) {
    hlen = rd16(base + off + 8);
    hstart = off + 10;
  } else {                                   // v2/v3: 4-byte header length
    if (off + 12 > limit) return false;
    hlen = rd32(base + off + 8);
    hstart = off + 12;
  }
  if (hstart + hlen > limit) return false;
  std::string h(reinterpret_cast<const char*>(base + hstart), hlen);

  auto find_value = [&](const char* key) -> size_t {
    size_t k = h.find(key);
    if (k == std::string::npos) return std::string::npos;
    k = h.find(':', k);
    return k == std::string::npos ? k : k + 1;
  };

  size_t p = find_value("'descr'");
  if (p == std::string::npos) return false;
  size_t q1 = h.find('\'', p);
  size_t q2 = h.find('\'', q1 + 1);
  if (q1 == std::string::npos || q2 == std::string::npos) return false;
  m->descr = h.substr(q1 + 1, q2 - q1 - 1);

  p = find_value("'fortran_order'");
  if (p == std::string::npos) return false;
  size_t v = h.find_first_not_of(' ', p);
  m->fortran = (v != std::string::npos && h.compare(v, 4, "True") == 0) ? 1 : 0;

  p = find_value("'shape'");
  if (p == std::string::npos) return false;
  size_t lp = h.find('(', p), rp = h.find(')', p);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  m->ndim = 0;
  int64_t cur = -1;
  for (size_t i = lp + 1; i <= rp; ++i) {
    char c = h[i];
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (cur >= 0) {
      if (m->ndim >= 32) return false;
      m->shape[m->ndim++] = cur;
      cur = -1;
    }
  }
  // element size from descr tail (e.g. "<f4" -> 4; "|V2" -> 2)
  int64_t esize = 0;
  for (char c : m->descr)
    if (c >= '0' && c <= '9') esize = esize * 10 + (c - '0');
  if (esize <= 0) return false;
  int64_t count = 1;
  for (int i = 0; i < m->ndim; ++i) count *= m->shape[i];
  m->data_off = hstart + hlen;
  m->nbytes = static_cast<uint64_t>(count * esize);
  return m->data_off + m->nbytes <= limit;
}

}  // namespace

extern "C" {

void* sr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 22) { ::close(fd); return nullptr; }
  size_t size = static_cast<size_t>(st.st_size);
  void* map = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) { ::close(fd); return nullptr; }
  const uint8_t* base = static_cast<const uint8_t*>(map);

  // end-of-central-directory: scan back over the (usually empty) comment
  int64_t eocd = -1;
  int64_t lo = static_cast<int64_t>(size) - 22;
  int64_t stop = lo > 65557 ? lo - 65557 : 0;
  for (int64_t i = lo; i >= stop; --i) {
    if (rd32(base + i) == 0x06054b50u) { eocd = i; break; }
  }
  auto fail = [&]() -> void* {
    munmap(map, size); ::close(fd); return nullptr;
  };
  if (eocd < 0) return fail();
  uint16_t count = rd16(base + eocd + 10);
  uint32_t cd_off = rd32(base + eocd + 16);
  if (cd_off >= size) return fail();

  Reader* r = new Reader{fd, base, size, {}};
  uint64_t p = cd_off;
  for (uint16_t i = 0; i < count; ++i) {
    if (p + 46 > size || rd32(base + p) != 0x02014b50u) { delete r; return fail(); }
    uint16_t method = rd16(base + p + 10);
    uint16_t nlen = rd16(base + p + 28);
    uint16_t xlen = rd16(base + p + 30);
    uint16_t clen = rd16(base + p + 32);
    uint32_t local_off = rd32(base + p + 42);
    std::string name(reinterpret_cast<const char*>(base + p + 46), nlen);
    p += 46 + nlen + xlen + clen;
    if (method != 0) { delete r; return fail(); }   // stored only (np.savez)
    if (local_off + 30 > size ||
        rd32(base + local_off) != 0x04034b50u) { delete r; return fail(); }
    uint16_t lnlen = rd16(base + local_off + 26);
    uint16_t lxlen = rd16(base + local_off + 28);
    uint64_t npy_off = static_cast<uint64_t>(local_off) + 30 + lnlen + lxlen;
    Member m;
    // strip the ".npy" suffix np.savez appends to member names
    m.name = (name.size() > 4 && name.compare(name.size() - 4, 4, ".npy") == 0)
                 ? name.substr(0, name.size() - 4) : name;
    if (!parse_npy(base, size, npy_off, &m)) { delete r; return fail(); }
    r->members.push_back(std::move(m));
  }
  return r;
}

int sr_num_members(void* h) {
  return static_cast<int>(static_cast<Reader*>(h)->members.size());
}

const char* sr_member_name(void* h, int i) {
  return static_cast<Reader*>(h)->members[i].name.c_str();
}

const char* sr_member_descr(void* h, int i) {
  return static_cast<Reader*>(h)->members[i].descr.c_str();
}

int sr_member_ndim(void* h, int i) {
  return static_cast<Reader*>(h)->members[i].ndim;
}

void sr_member_shape(void* h, int i, int64_t* out) {
  const Member& m = static_cast<Reader*>(h)->members[i];
  std::memcpy(out, m.shape, sizeof(int64_t) * m.ndim);
}

int sr_member_fortran(void* h, int i) {
  return static_cast<Reader*>(h)->members[i].fortran;
}

int64_t sr_member_nbytes(void* h, int i) {
  return static_cast<int64_t>(static_cast<Reader*>(h)->members[i].nbytes);
}

// GIL-free bulk copy of a member's payload into dst (caller sizes it).
int sr_read(void* h, int i, void* dst) {
  Reader* r = static_cast<Reader*>(h);
  const Member& m = r->members[i];
  std::memcpy(dst, r->map + m.data_off, m.nbytes);
  return 0;
}

// Zero-copy pointer into the mmap (valid until sr_close).
const void* sr_member_ptr(void* h, int i) {
  Reader* r = static_cast<Reader*>(h);
  return r->map + r->members[i].data_off;
}

void sr_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  munmap(const_cast<uint8_t*>(r->map), r->size);
  ::close(r->fd);
  delete r;
}

}  // extern "C"
