// Big-endian field-per-file codec, native side.  See codec.cc.
#pragma once
#include <cstdint>
#include <string>
#include <vector>

namespace wrf_native {
int32_t read_int(const std::string& path);
float read_real(const std::string& path);
std::vector<float> read_field(const std::string& path, size_t count);
void write_field(const std::string& path, const float* data, size_t count);
void write_int(const std::string& path, int32_t value);
}  // namespace wrf_native
