// Big-endian field-per-file binary codec (native side).
//
// Same on-disk format as the Python codec (wrf_tpu_torch/io/codec.py) and the
// reference fixtures: raw big-endian int32/float32 streams, field files laid
// out i-fastest, then k, then j (reference: advance_mu_t_driver.c:302-415,
// advance_mu_t_driver.f90:330 convert="big_endian").

#include "codec.h"

#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace wrf_native {

namespace {
inline uint32_t bswap32(uint32_t x) {
  return ((x & 0xff000000u) >> 24) | ((x & 0x00ff0000u) >> 8) |
         ((x & 0x0000ff00u) << 8) | ((x & 0x000000ffu) << 24);
}
inline bool host_is_little_endian() {
  const uint16_t probe = 1;
  uint8_t byte;
  std::memcpy(&byte, &probe, 1);
  return byte == 1;
}

std::vector<uint8_t> read_all(const std::string& path) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) throw std::runtime_error("cannot open " + path);
  std::fseek(fp, 0, SEEK_END);
  const long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (size > 0 && std::fread(buf.data(), 1, buf.size(), fp) != buf.size()) {
    std::fclose(fp);
    throw std::runtime_error("short read on " + path);
  }
  std::fclose(fp);
  return buf;
}

void write_all(const std::string& path, const void* data, size_t bytes) {
  FILE* fp = std::fopen(path.c_str(), "wb");
  if (!fp) throw std::runtime_error("cannot open for write " + path);
  if (bytes > 0 && std::fwrite(data, 1, bytes, fp) != bytes) {
    std::fclose(fp);
    throw std::runtime_error("short write on " + path);
  }
  std::fclose(fp);
}
}  // namespace

int32_t read_int(const std::string& path) {
  const auto buf = read_all(path);
  if (buf.size() < 4) throw std::runtime_error("short int file " + path);
  uint32_t raw;
  std::memcpy(&raw, buf.data(), 4);
  if (host_is_little_endian()) raw = bswap32(raw);
  int32_t out;
  std::memcpy(&out, &raw, 4);
  return out;
}

float read_real(const std::string& path) {
  const auto buf = read_all(path);
  if (buf.size() < 4) throw std::runtime_error("short real file " + path);
  uint32_t raw;
  std::memcpy(&raw, buf.data(), 4);
  if (host_is_little_endian()) raw = bswap32(raw);
  float out;
  std::memcpy(&out, &raw, 4);
  return out;
}

std::vector<float> read_field(const std::string& path, size_t count) {
  const auto buf = read_all(path);
  if (buf.size() < count * 4)
    throw std::runtime_error("field file too small: " + path);
  std::vector<float> out(count);
  const bool swap = host_is_little_endian();
  for (size_t n = 0; n < count; ++n) {
    uint32_t raw;
    std::memcpy(&raw, buf.data() + n * 4, 4);
    if (swap) raw = bswap32(raw);
    std::memcpy(&out[n], &raw, 4);
  }
  return out;
}

void write_field(const std::string& path, const float* data, size_t count) {
  std::vector<uint32_t> raw(count);
  const bool swap = host_is_little_endian();
  for (size_t n = 0; n < count; ++n) {
    uint32_t bits;
    std::memcpy(&bits, &data[n], 4);
    raw[n] = swap ? bswap32(bits) : bits;
  }
  write_all(path, raw.data(), count * 4);
}

void write_int(const std::string& path, int32_t value) {
  uint32_t raw;
  std::memcpy(&raw, &value, 4);
  if (host_is_little_endian()) raw = bswap32(raw);
  write_all(path, &raw, 4);
}

}  // namespace wrf_native

extern "C" void wrf_swap_4d(const float* in, float* out, int64_t idim,
                            int64_t kdim, int64_t jdim, int64_t mdim) {
  // (j, m, k, i) -> (m, j, k, i); each (k, i) plane is contiguous in both
  const size_t plane = static_cast<size_t>(kdim) * idim;
  for (int64_t j = 0; j < jdim; ++j)
    for (int64_t m = 0; m < mdim; ++m)
      std::memcpy(out + (m * jdim + j) * plane, in + (j * mdim + m) * plane,
                  plane * sizeof(float));
}
