// Native host-side feeder: scan-file parsing, extrinsic transform, range/blind
// filtering, time-ordered point buffering, and uniform-grid IMU resampling.
//
// This is the C++ runtime counterpart of the reference's host path — the work
// its node + LidarOdometry do before anything numeric happens per sweep:
// pcl::fromROSMsg + extrinsic transform + range/blind-box filter + points_buff_
// (lidar_odometry.cc:487-515) and ImuResampler (sensor/imu_resampler.h). The
// TPU compute path stays in JAX; this library keeps the Python driver thin and
// the per-sweep feed preparation allocation-free and single-pass.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). All buffers are
// owned by the handle; pop_* functions copy into caller-provided arrays.
//
// Build: make -C native   (produces libwcfeeder.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr uint32_t kWcsMagic = 0x57435331;  // "WCS1", io/dataset.py

struct Feeder {
  double rot[9];  // row-major lidar->imu rotation
  double pos[3];
  double min_range2, max_range2;
  double bb_min[3], bb_max[3];

  std::deque<double> t;
  std::deque<float> xyz;  // 3 per point, imu frame

  bool keep(const double p[3]) const {
    const double r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
    // written as accept-conditions so NaN returns (which compare false) are
    // dropped — matching the NumPy path, where NaN fails the keep mask
    if (!(r2 >= min_range2 && r2 <= max_range2)) return false;
    const bool in_box = p[0] >= bb_min[0] && p[0] <= bb_max[0] &&
                        p[1] >= bb_min[1] && p[1] <= bb_max[1] &&
                        p[2] >= bb_min[2] && p[2] <= bb_max[2];
    return !in_box;
  }

  void transform(const float in[3], double out[3]) const {
    for (int r = 0; r < 3; ++r) {
      out[r] = rot[3 * r] * in[0] + rot[3 * r + 1] * in[1] +
               rot[3 * r + 2] * in[2] + pos[r];
    }
  }
};

struct Resampler {
  double rate;
  long grid_k = 0;
  bool started = false;
  double t0 = 0;
  double tp = 0;
  double accp[3] = {0, 0, 0}, gyrp[3] = {0, 0, 0};
};

}  // namespace

extern "C" {

void* wc_feeder_create(const double* rot, const double* pos, double min_range,
                       double max_range, const double* bb_min,
                       const double* bb_max) {
  auto* f = new Feeder();
  std::memcpy(f->rot, rot, sizeof(f->rot));
  std::memcpy(f->pos, pos, sizeof(f->pos));
  f->min_range2 = min_range * min_range;
  f->max_range2 = max_range * max_range;
  std::memcpy(f->bb_min, bb_min, sizeof(f->bb_min));
  std::memcpy(f->bb_max, bb_max, sizeof(f->bb_max));
  return f;
}

void wc_feeder_destroy(void* h) { delete static_cast<Feeder*>(h); }

// Append points given in the LIDAR frame; returns number kept after filters.
long wc_feeder_add_points(void* h, long n, const double* times,
                          const float* pts_lidar) {
  auto* f = static_cast<Feeder*>(h);
  long kept = 0;
  for (long i = 0; i < n; ++i) {
    double p[3];
    f->transform(&pts_lidar[3 * i], p);
    if (!f->keep(p)) continue;
    f->t.push_back(times[i]);
    f->xyz.push_back(static_cast<float>(p[0]));
    f->xyz.push_back(static_cast<float>(p[1]));
    f->xyz.push_back(static_cast<float>(p[2]));
    ++kept;
  }
  return kept;
}

// Read a .wcs scan file (io/dataset.py format), filter + buffer. Returns kept
// count, or -1 on I/O error, -2 on format error.
long wc_feeder_load_scan(void* h, const char* path) {
  auto* f = static_cast<Feeder*>(h);
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  uint32_t magic = 0, count = 0;
  double t0 = 0;
  if (std::fread(&magic, 4, 1, fp) != 1 || std::fread(&count, 4, 1, fp) != 1 ||
      std::fread(&t0, 8, 1, fp) != 1 || magic != kWcsMagic) {
    std::fclose(fp);
    return -2;
  }
  std::vector<float> rec(static_cast<size_t>(count) * 4);
  const size_t got = std::fread(rec.data(), sizeof(float), rec.size(), fp);
  std::fclose(fp);
  if (got != rec.size()) return -2;

  long kept = 0;
  for (uint32_t i = 0; i < count; ++i) {
    double p[3];
    f->transform(&rec[4 * i + 1], p);
    if (!f->keep(p)) continue;
    f->t.push_back(t0 + static_cast<double>(rec[4 * i]));
    f->xyz.push_back(static_cast<float>(p[0]));
    f->xyz.push_back(static_cast<float>(p[1]));
    f->xyz.push_back(static_cast<float>(p[2]));
    ++kept;
  }
  return kept;
}

long wc_feeder_size(void* h) { return static_cast<Feeder*>(h)->t.size(); }

double wc_feeder_front_time(void* h) {
  auto* f = static_cast<Feeder*>(h);
  return f->t.empty() ? NAN : f->t.front();
}

double wc_feeder_back_time(void* h) {
  auto* f = static_cast<Feeder*>(h);
  return f->t.empty() ? NAN : f->t.back();
}

// Drop buffered points with time < t_cut (head sync, lidar_odometry.cc:477-480).
long wc_feeder_drop_before(void* h, double t_cut) {
  auto* f = static_cast<Feeder*>(h);
  long dropped = 0;
  while (!f->t.empty() && f->t.front() < t_cut) {
    f->t.pop_front();
    f->xyz.pop_front();
    f->xyz.pop_front();
    f->xyz.pop_front();
    ++dropped;
  }
  return dropped;
}

// Number of buffered points with time < t_end (non-destructive). Callers use
// this before pop_sweep to detect overfull sweeps and size a temporary buffer
// for host-side decimation instead of silently losing the tail.
long wc_feeder_count_until(void* h, double t_end) {
  auto* f = static_cast<Feeder*>(h);
  return std::lower_bound(f->t.begin(), f->t.end(), t_end) - f->t.begin();
}

// Pop points with time < t_end into caller arrays (cap max_n; excess beyond
// max_n is discarded — callers are expected to size via count_until first).
// out_times may receive times relative to `epoch` for direct f32 device feed.
long wc_feeder_pop_sweep(void* h, double t_end, double epoch, long max_n,
                         float* out_times, float* out_xyz) {
  auto* f = static_cast<Feeder*>(h);
  long n = 0;
  while (!f->t.empty() && f->t.front() < t_end) {
    if (n < max_n) {
      out_times[n] = static_cast<float>(f->t.front() - epoch);
      out_xyz[3 * n] = f->xyz[0];
      out_xyz[3 * n + 1] = f->xyz[1];
      out_xyz[3 * n + 2] = f->xyz[2];
    }
    f->t.pop_front();
    f->xyz.pop_front();
    f->xyz.pop_front();
    f->xyz.pop_front();
    ++n;
  }
  return n < max_n ? n : max_n;
}

// Copy the buffered (already filtered, IMU-frame) points without consuming
// them — checkpoint support.
long wc_feeder_peek(void* h, long max_n, double* out_t, float* out_xyz) {
  auto* f = static_cast<Feeder*>(h);
  const long n = static_cast<long>(f->t.size());
  const long m = n < max_n ? n : max_n;
  for (long i = 0; i < m; ++i) {
    out_t[i] = f->t[i];
    out_xyz[3 * i] = f->xyz[3 * i];
    out_xyz[3 * i + 1] = f->xyz[3 * i + 1];
    out_xyz[3 * i + 2] = f->xyz[3 * i + 2];
  }
  return m;
}

// Append points that are ALREADY filtered and in the IMU frame (checkpoint
// restore) — no extrinsic, no filters.
void wc_feeder_push_filtered(void* h, long n, const double* t, const float* xyz) {
  auto* f = static_cast<Feeder*>(h);
  for (long i = 0; i < n; ++i) {
    f->t.push_back(t[i]);
    f->xyz.push_back(xyz[3 * i]);
    f->xyz.push_back(xyz[3 * i + 1]);
    f->xyz.push_back(xyz[3 * i + 2]);
  }
}

// ---------------------------------------------------------------------------
// IMU resampler (sensor/imu_resampler.h semantics; see
// wildcat_slam_tpu/odometry/imu.py ImuResampler for the grid definition)
// ---------------------------------------------------------------------------

void* wc_resampler_create(double rate) {
  auto* r = new Resampler();
  r->rate = rate;
  return r;
}

void wc_resampler_destroy(void* h) { delete static_cast<Resampler*>(h); }

// Feed one raw sample; writes up to max_out resampled samples into out_t /
// out_acc / out_gyr. Returns count emitted.
long wc_resampler_add(void* h, double t, const double* acc, const double* gyr,
                      long max_out, double* out_t, double* out_acc,
                      double* out_gyr) {
  auto* r = static_cast<Resampler*>(h);
  long n = 0;
  if (!r->started) {
    r->started = true;
    r->t0 = t;
    r->tp = t;
    std::memcpy(r->accp, acc, 24);
    std::memcpy(r->gyrp, gyr, 24);
    r->grid_k = 1;
    if (max_out > 0) {
      out_t[0] = t;
      std::memcpy(out_acc, acc, 24);
      std::memcpy(out_gyr, gyr, 24);
      n = 1;
    }
    return n;
  }
  while (true) {
    // exact same expression as the Python resampler: t0 + k / rate
    const double target = r->t0 + static_cast<double>(r->grid_k) / r->rate;
    if (target > t) break;
    if (target >= r->tp && n < max_out) {
      const double f = (t == r->tp) ? 0.0 : (target - r->tp) / (t - r->tp);
      out_t[n] = target;
      for (int i = 0; i < 3; ++i) {
        out_acc[3 * n + i] = (1 - f) * r->accp[i] + f * acc[i];
        out_gyr[3 * n + i] = (1 - f) * r->gyrp[i] + f * gyr[i];
      }
      ++n;
    }
    ++r->grid_k;
  }
  r->tp = t;
  std::memcpy(r->accp, acc, 24);
  std::memcpy(r->gyrp, gyr, 24);
  return n;
}

double wc_resampler_t0(void* h) { return static_cast<Resampler*>(h)->t0; }

// Serialize/restore the resampler (checkpoint support): 11 doubles =
// started, grid_k, t0, tp, accp[3], gyrp[3].
void wc_resampler_get_state(void* h, double* out) {
  auto* r = static_cast<Resampler*>(h);
  out[0] = r->started ? 1.0 : 0.0;
  out[1] = static_cast<double>(r->grid_k);
  out[2] = r->t0;
  out[3] = r->tp;
  for (int i = 0; i < 3; ++i) out[4 + i] = r->accp[i];
  for (int i = 0; i < 3; ++i) out[7 + i] = r->gyrp[i];
}

void wc_resampler_set_state(void* h, const double* in) {
  auto* r = static_cast<Resampler*>(h);
  r->started = in[0] != 0.0;
  r->grid_k = static_cast<long>(in[1]);
  r->t0 = in[2];
  r->tp = in[3];
  for (int i = 0; i < 3; ++i) r->accp[i] = in[4 + i];
  for (int i = 0; i < 3; ++i) r->gyrp[i] = in[7 + i];
}

}  // extern "C"
