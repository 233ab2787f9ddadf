// Fast parser for the transposed 4-row SDD annotation CSVs
// (row0=frames, row1=ids, row2=xs, row3=ys — layout from the reference
// preprocessor, scripts/preprocess.py:31-34 of the TensorFlow reference).
//
// The reference ingested these with np.genfromtxt in a Python loop
// (utils/data_loader.py:98), its slowest host loop. This
// parser reads the file once and strtod's all four rows in one pass
// (~30-60x faster on the 3.5M-record tree).
//
// The port's own copy of desire_tpu/data/native/fast_csv.cpp.
// Build: python -m desire_tpu_torch.data.native.build
// ABI: plain C, consumed via ctypes (fast_csv.py).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Read the whole file into a NUL-terminated heap buffer. (An earlier mmap
// version let strtod run past the mapping when a file ended exactly on a
// page boundary with a trailing digit — strtod needs a terminator.)
struct Loaded {
  char* data = nullptr;
  size_t size = 0;
  bool ok() const { return data != nullptr; }
};

Loaded load_file(const char* path) {
  Loaded m;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return m;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return m;
  }
  char* buf = static_cast<char*>(malloc(st.st_size + 1));
  if (!buf) {
    close(fd);
    return m;
  }
  size_t got = 0;
  while (got < static_cast<size_t>(st.st_size)) {
    ssize_t r = read(fd, buf + got, st.st_size - got);
    if (r <= 0) break;
    got += r;
  }
  close(fd);
  if (got != static_cast<size_t>(st.st_size)) {
    free(buf);
    return m;
  }
  buf[st.st_size] = '\0';
  m.data = buf;
  m.size = st.st_size;
  return m;
}

void unload(Loaded& m) { free(m.data); }

}  // namespace

extern "C" {

// Number of comma-separated fields in the first line, or -1 on I/O error.
long count_fields(const char* path) {
  Loaded m = load_file(path);
  if (!m.ok()) return -1;
  long n = 1;
  for (size_t i = 0; i < m.size; ++i) {
    char c = m.data[i];
    if (c == ',') ++n;
    else if (c == '\n') break;
  }
  unload(m);
  return n;
}

// Parse 4 rows x n fields into out[4*n] (row-major). Returns the number of
// fields parsed in the shortest row (== n on success).
long parse_csv4(const char* path, long n, double* out) {
  Loaded m = load_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  long min_row = n;
  for (int row = 0; row < 4; ++row) {
    long col = 0;
    while (p < end && *p != '\n' && col < n) {
      char* next = nullptr;
      out[row * n + col] = strtod(p, &next);
      if (next == p) {  // empty field
        out[row * n + col] = 0.0;
        ++next;
      }
      p = next;
      if (p < end && *p == ',') ++p;
      ++col;
    }
    if (col < min_row) min_row = col;
    while (p < end && *p != '\n') ++p;  // skip trailing junk
    if (p < end) ++p;                   // consume newline
  }
  unload(m);
  return min_row;
}

}  // extern "C"
