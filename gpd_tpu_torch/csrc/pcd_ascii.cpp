// Bulk parsing of whitespace-separated floats for ascii PCD bodies, the
// host side's largest cost when loading a large cloud file. The port's own
// copy of gpd_tpu's parse_ascii_floats (native/pcd_native.cpp:28-56).
//
// Built at first use with the host C++ compiler
// (gpd_tpu_torch/ops/_build.py: c++ -O3 -fPIC -shared -std=c++17) and
// called through ctypes by gpd_tpu_torch/io/pcd.py.

#include <cstdlib>

extern "C" {

// Parse up to max_out whitespace-separated floats from text[0..len) into
// out. Tokens that are not numbers are skipped. Returns the number parsed.
long long parse_ascii_floats(const char* text, long long len, float* out,
                             long long max_out) {
  const char* p = text;
  const char* end = text + len;
  long long n = 0;
  while (p < end && n < max_out) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
      ++p;
    }
    if (p >= end) break;
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) {
      // Not a number ("nan" and "inf" are): skip the token.
      while (p < end && !(*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
        ++p;
      }
      continue;
    }
    out[n++] = v;
    p = next;
  }
  return n;
}

}  // extern "C"
