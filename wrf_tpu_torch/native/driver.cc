// Native CLI verification driver.
//
// Framework equivalent of the reference's driver executables
// (advance_mu_t_driver.c:37-289): load a golden binary fixture directory,
// run the native advance_mu_t kernel for N small steps, time the kernel
// window, and differentially verify every output field against the golden
// outputs, reporting equal/diff counts, max rel/abs error, max ULP and RMSE.
//
// Usage: wrf_tpu_torch_driver <fixture_dir> [steps]
//   steps defaults to the fixture's steps.bin (or 1 if absent).

#include <sys/time.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "codec.h"
#include "wrf_tpu_native.h"

using wrf_native::read_field;
using wrf_native::read_int;
using wrf_native::read_real;

namespace {

double now_ms() {
  struct timeval tv;
  gettimeofday(&tv, nullptr);
  return tv.tv_sec * 1000.0 + tv.tv_usec / 1000.0;
}

struct Fixture {
  std::string dir;
  std::string path(const char* name) const { return dir + "/" + name; }
  int32_t dim(const char* name) const { return read_int(path(name)); }
  std::vector<float> f3(const char* name, const wrf_window& w) const {
    return read_field(path(name),
                      static_cast<size_t>(w.jdim) * w.kdim * w.idim);
  }
  std::vector<float> f2(const char* name, const wrf_window& w) const {
    return read_field(path(name), static_cast<size_t>(w.jdim) * w.idim);
  }
  std::vector<float> f1(const char* name, const wrf_window& w) const {
    return read_field(path(name), static_cast<size_t>(w.kdim));
  }
};

int report(const Fixture& fx, const char* name, const std::vector<float>& got) {
  const auto golden = read_field(fx.path(name), got.size());
  wrf_compare_result r;
  wrf_compare(got.data(), golden.data(), static_cast<int64_t>(got.size()), &r);
  std::printf(
      "%-24s equal=%-9lld diff=%-9lld max_rel=%.6e max_abs=%.6e max_ulp=%lld "
      "rmse=%.6e%s\n",
      name, static_cast<long long>(r.equal),
      static_cast<long long>(r.different), r.max_rel_err, r.max_abs_err,
      static_cast<long long>(r.max_ulp), r.rmse,
      r.nan_seen ? "  [NaN DETECTED]" : "");
  return r.nan_seen ? 1 : 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <fixture_dir> [steps]\n", argv[0]);
    return 2;
  }
  Fixture fx{argv[1]};

  // Index triples (1-based inclusive, WRF convention).
  const int ids = fx.dim("ids.bin"), ide = fx.dim("ide.bin");
  const int jds = fx.dim("jds.bin"), jde = fx.dim("jde.bin");
  const int kds = fx.dim("kds.bin"), kde = fx.dim("kde.bin");
  const int ims = fx.dim("ims.bin"), ime = fx.dim("ime.bin");
  const int jms = fx.dim("jms.bin"), jme = fx.dim("jme.bin");
  const int kms = fx.dim("kms.bin"), kme = fx.dim("kme.bin");
  const int its = fx.dim("its.bin"), ite = fx.dim("ite.bin");
  const int jts = fx.dim("jts.bin"), jte = fx.dim("jte.bin");
  const int kts = fx.dim("kts.bin"), kte = fx.dim("kte.bin");
  (void)kds;

  const int nested = fx.dim("config_flags_nested.bin");
  const int periodic_x = fx.dim("config_flags_periodic_x.bin");
  const int specified = fx.dim("config_flags_specified.bin");

  wrf_window w;
  w.idim = ime - ims + 1;
  w.jdim = jme - jms + 1;
  w.kdim = kme - kms + 1;
  // Boundary-condition-aware window (the reference kernels' bound shrinking,
  // module_small_step_em.f90:91-106), resolved to 0-based memory offsets.
  int i_start = its, i_end = ite < ide - 1 ? ite : ide - 1;
  int j_start = jts, j_end = jte < jde - 1 ? jte : jde - 1;
  if (!periodic_x && (specified || nested)) {
    i_start = its > ids + 1 ? its : ids + 1;
    i_end = ite < ide - 2 ? ite : ide - 2;
  }
  if (specified || nested) {
    j_start = jts > jds + 1 ? jts : jds + 1;
    j_end = jte < jde - 2 ? jte : jde - 2;
  }
  w.i0 = i_start - ims;
  w.i1 = i_end - ims;
  w.j0 = j_start - jms;
  w.j1 = j_end - jms;
  w.k0 = kts - kms;
  w.k1 = kte - 1 - kms;
  w.kde = kde - kms;

  int steps = 1;
  if (argc >= 3) {
    steps = std::atoi(argv[2]);
  } else {
    try {
      steps = fx.dim("steps.bin");
    } catch (...) {
    }
  }

  const float rdx = read_real(fx.path("grid_rdx.bin"));
  const float rdy = read_real(fx.path("grid_rdy.bin"));
  const float dts = read_real(fx.path("dts_rk.bin"));
  const float epssm = read_real(fx.path("grid_epssm.bin"));

  auto dnw = fx.f1("grid_dnw.bin", w), fnm = fx.f1("grid_fnm.bin", w);
  auto fnp = fx.f1("grid_fnp.bin", w), rdnw = fx.f1("grid_rdnw.bin", w);

  auto mut = fx.f2("grid_mut.bin", w), muu = fx.f2("grid_muu.bin", w);
  auto muv = fx.f2("grid_muv.bin", w), mu_tend = fx.f2("mu_tend.bin", w);
  auto msfuy = fx.f2("grid_msfuy.bin", w);
  auto msfvx_inv = fx.f2("grid_msfvx_inv.bin", w);
  auto msftx = fx.f2("grid_msftx.bin", w), msfty = fx.f2("grid_msfty.bin", w);
  auto mu = fx.f2("grid_mu_2.bin", w);
  std::vector<float> muave(mu.size(), 0.0f), muts(mu.size(), 0.0f),
      mudf(mu.size(), 0.0f);

  auto u = fx.f3("grid_u_2.bin", w), u_1 = fx.f3("grid_u_save.bin", w);
  auto v = fx.f3("grid_v_2.bin", w), v_1 = fx.f3("grid_v_save.bin", w);
  auto t_1 = fx.f3("grid_t_save.bin", w), ft = fx.f3("t_tend.bin", w);
  auto ww = fx.f3("grid_ww.bin", w), ww_1 = fx.f3("ww1.bin", w);
  auto t = fx.f3("grid_t_2.bin", w), t_ave = fx.f3("t_2save.bin", w);

  const double t0 = now_ms();
  for (int s = 0; s < steps; ++s) {
    const int rc = wrf_advance_mu_t(
        &w, ww.data(), ww_1.data(), u.data(), u_1.data(), v.data(), v_1.data(),
        mu.data(), mut.data(), muave.data(), muts.data(), muu.data(),
        muv.data(), mudf.data(), t.data(), t_1.data(), t_ave.data(), ft.data(),
        mu_tend.data(), rdx, rdy, dts, epssm, dnw.data(), fnm.data(),
        fnp.data(), rdnw.data(), msfuy.data(), msfvx_inv.data(), msftx.data(),
        msfty.data());
    if (rc != 0) {
      std::fprintf(stderr, "kernel failed with rc=%d\n", rc);
      return 1;
    }
  }
  const double t1 = now_ms();
  const double pts = static_cast<double>(w.i1 - w.i0 + 1) *
                     (w.j1 - w.j0 + 1) * (w.k1 - w.k0 + 1) * steps;
  std::printf("advance_mu_t native: %d step(s) in %.3f ms  (%.3f ms/step, "
              "%.3e grid-points/s)\n",
              steps, t1 - t0, (t1 - t0) / steps, pts / ((t1 - t0) / 1000.0));

  int nan_rc = 0;
  nan_rc |= report(fx, "grid_ww_output.bin", ww);
  nan_rc |= report(fx, "ww1_output.bin", ww_1);
  nan_rc |= report(fx, "grid_t_2_output.bin", t);
  nan_rc |= report(fx, "t_2save_output.bin", t_ave);
  nan_rc |= report(fx, "grid_mu_2_output.bin", mu);
  nan_rc |= report(fx, "muave_output.bin", muave);
  nan_rc |= report(fx, "grid_muts_output.bin", muts);
  nan_rc |= report(fx, "grid_mudf_output.bin", mudf);
  return nan_rc;
}
