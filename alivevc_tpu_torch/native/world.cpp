// C++ implementation of the WORLD-style F0 estimator (DIO + StoneMask).
//
// Native counterpart of alivevc_tpu/ops/world.py — the host-side label
// generator for F0-estimator training (the reference reaches the same
// functionality through the pyworld C++ library, module/common.py:113-137).
// Same algorithm as the Python implementation so the two can be compared
// directly in tests: band-wise Nuttall-windowed-sinc low-pass filtering,
// four event-interval period estimates (zero-crossings up/down, peaks, dips)
// per band, reliability = relative stddev, best-band selection, WORLD's
// FixF0Contour post-processing (octave-jump elimination, short-segment
// removal, candidate-based section extension — mirrors
// ops/world.py:fix_f0_contour), then StoneMask refinement via
// amplitude-weighted instantaneous frequency of the first harmonics around a
// 3-period Blackman window.
//
// Exposed as a C ABI for ctypes (alivevc_tpu/native_bindings.py).

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// small radix-2 FFT (iterative, complex double) — segments are zero-padded to
// a power of two by the caller.
// ---------------------------------------------------------------------------

void fft_inplace(std::vector<std::complex<double>>& a) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = -2.0 * kPi / static_cast<double>(len);
    const std::complex<double> wl(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      std::complex<double> w(1.0, 0.0);
      for (size_t k = 0; k < len / 2; ++k) {
        const std::complex<double> u = a[i + k];
        const std::complex<double> v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wl;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// DIO pieces
// ---------------------------------------------------------------------------

std::vector<double> nuttall_lowpass(double cutoff_hz, double fs) {
  const int half = static_cast<int>(std::lround(fs / cutoff_hz * 2.0));
  const int len = 2 * half + 1;
  std::vector<double> h(len);
  double sum = 0.0;
  for (int i = 0; i < len; ++i) {
    const double m = i - half;
    const double x = 2.0 * cutoff_hz / fs * m;
    const double sinc = (x == 0.0) ? 1.0 : std::sin(kPi * x) / (kPi * x);
    const double t = static_cast<double>(i) / (2 * half);
    const double win = 0.355768 - 0.487396 * std::cos(2 * kPi * t) +
                       0.144232 * std::cos(4 * kPi * t) -
                       0.012604 * std::cos(6 * kPi * t);
    h[i] = sinc * (2.0 * cutoff_hz / fs) * win;
    sum += h[i];
  }
  for (double& v : h) v /= sum;
  return h;
}

// 'same' FIR convolution
std::vector<double> fir_same(const std::vector<double>& x,
                             const std::vector<double>& h) {
  const int n = static_cast<int>(x.size());
  const int k = static_cast<int>(h.size());
  const int half = k / 2;
  std::vector<double> y(n, 0.0);
  for (int i = 0; i < n; ++i) {
    double acc = 0.0;
    const int j0 = std::max(0, i - half);
    const int j1 = std::min(n - 1, i + half);
    for (int j = j0; j <= j1; ++j) acc += x[j] * h[i - j + half];
    y[i] = acc;
  }
  return y;
}

struct Events {
  std::vector<double> centers;  // seconds
  std::vector<double> f0;       // Hz
};

enum EventKind { kZcUp, kZcDown, kPeak, kDip };

Events event_intervals(const std::vector<double>& x, double fs, EventKind kind) {
  std::vector<double> times;
  const int n = static_cast<int>(x.size());
  if (kind == kZcUp || kind == kZcDown) {
    for (int i = 0; i + 1 < n; ++i) {
      const bool up = x[i] < 0 && x[i + 1] >= 0;
      const bool down = x[i] >= 0 && x[i + 1] < 0;
      if ((kind == kZcUp && up) || (kind == kZcDown && down)) {
        double frac = 0.0;
        const double denom = x[i + 1] - x[i];
        if (denom != 0.0) frac = (kind == kZcUp ? -x[i] : x[i]) / (kind == kZcUp ? denom : -denom);
        times.push_back((i + frac) / fs);
      }
    }
  } else {
    for (int i = 1; i + 1 < n; ++i) {
      const double d0 = x[i] - x[i - 1];
      const double d1 = x[i + 1] - x[i];
      if ((kind == kPeak && d0 > 0 && d1 <= 0) || (kind == kDip && d0 < 0 && d1 >= 0)) {
        times.push_back(static_cast<double>(i) / fs);
      }
    }
  }
  Events ev;
  for (size_t i = 0; i + 1 < times.size(); ++i) {
    const double interval = times[i + 1] - times[i];
    if (interval <= 0) continue;
    ev.centers.push_back((times[i] + times[i + 1]) / 2.0);
    ev.f0.push_back(1.0 / interval);
  }
  return ev;
}

// linear interp of (centers, f0) onto frame times; 0 outside the span
std::vector<double> interp_to_frames(const Events& ev,
                                     const std::vector<double>& frame_t) {
  std::vector<double> out(frame_t.size(), 0.0);
  if (ev.centers.size() < 2) return out;
  size_t j = 0;
  for (size_t i = 0; i < frame_t.size(); ++i) {
    const double t = frame_t[i];
    if (t < ev.centers.front() || t > ev.centers.back()) continue;
    while (j + 2 < ev.centers.size() && ev.centers[j + 1] < t) ++j;
    while (j > 0 && ev.centers[j] > t) --j;
    const double t0 = ev.centers[j], t1 = ev.centers[j + 1];
    const double w = (t1 > t0) ? (t - t0) / (t1 - t0) : 0.0;
    out[i] = ev.f0[j] * (1.0 - w) + ev.f0[j + 1] * w;
  }
  return out;
}

// contiguous voiced (>0) frame runs as (start, end_exclusive)
std::vector<std::pair<int, int>> voiced_runs(const std::vector<double>& f0) {
  std::vector<std::pair<int, int>> runs;
  int start = -1;
  for (int i = 0; i < static_cast<int>(f0.size()); ++i) {
    if (f0[i] > 0 && start < 0) start = i;
    else if (f0[i] <= 0 && start >= 0) { runs.emplace_back(start, i); start = -1; }
  }
  if (start >= 0) runs.emplace_back(start, static_cast<int>(f0.size()));
  return runs;
}

// WORLD DIO FixF0Contour — mirrors ops/world.py:fix_f0_contour exactly.
void fix_f0_contour(std::vector<double>& f0,
                    const std::vector<std::vector<double>>& cand_f0,
                    double allowed_range, int min_voiced_frames = 6,
                    int max_extend = 10) {
  const int n = static_cast<int>(f0.size());
  // 1. octave-jump elimination (forward scan vs original previous frame)
  std::vector<double> base(f0);
  for (int i = 1; i < n; ++i) {
    if (base[i] > 0 && base[i - 1] > 0 &&
        std::fabs(base[i] - base[i - 1]) / std::max(base[i - 1], 1e-12) >
            allowed_range) {
      f0[i] = 0.0;
    }
  }
  // 2. short-segment removal
  for (const auto& run : voiced_runs(f0)) {
    if (run.second - run.first < min_voiced_frames) {
      for (int i = run.first; i < run.second; ++i) f0[i] = 0.0;
    }
  }
  // 3. candidate-based forward/backward extension of each section
  const auto runs = voiced_runs(f0);
  const int n_bands = static_cast<int>(cand_f0.size());
  for (size_t ri = 0; ri < runs.size(); ++ri) {
    const int s = runs[ri].first, e = runs[ri].second;
    const int nxt_start = (ri + 1 < runs.size()) ? runs[ri + 1].first : n;
    double ref = f0[e - 1];
    for (int j = e; j < std::min(e + max_extend, nxt_start); ++j) {
      int best = -1;
      double best_rel = 1e30;
      for (int b = 0; b < n_bands; ++b) {
        if (cand_f0[b][j] <= 0) continue;
        const double rel = std::fabs(cand_f0[b][j] - ref) / std::max(ref, 1e-12);
        if (rel < best_rel) { best_rel = rel; best = b; }
      }
      if (best < 0 || best_rel > allowed_range) break;
      f0[j] = cand_f0[best][j];
      ref = f0[j];
    }
    const int prev_end = (ri > 0) ? runs[ri - 1].second : 0;
    ref = f0[s];
    for (int j = s - 1; j > std::max(s - 1 - max_extend, prev_end - 1); --j) {
      if (f0[j] > 0) break;  // filled by the previous section's forward pass
      int best = -1;
      double best_rel = 1e30;
      for (int b = 0; b < n_bands; ++b) {
        if (cand_f0[b][j] <= 0) continue;
        const double rel = std::fabs(cand_f0[b][j] - ref) / std::max(ref, 1e-12);
        if (rel < best_rel) { best_rel = rel; best = b; }
      }
      if (best < 0 || best_rel > allowed_range) break;
      f0[j] = cand_f0[best][j];
      ref = f0[j];
    }
  }
}

double refine_frame(const std::vector<double>& x, double fs, double t,
                    double f0_init) {
  if (f0_init <= 0) return 0.0;
  const int half = static_cast<int>(std::lround(1.5 * fs / f0_init));
  const int c = static_cast<int>(std::lround(t * fs));
  const int lo = c - half, hi = c + half + 1;
  if (lo < 0 || hi + 1 > static_cast<int>(x.size())) return f0_init;
  const int seg_len = hi - lo;
  size_t n_fft = 1;
  while (n_fft < static_cast<size_t>(seg_len + 1)) n_fft <<= 1;
  n_fft <<= 1;  // match numpy: 2**ceil(log2(len+1)) == next pow2 > len
  // (numpy: int(2 ** ceil(log2(len+1))) — replicate exactly)
  {
    size_t p = 1;
    while (static_cast<double>(p) < static_cast<double>(seg_len + 1)) p <<= 1;
    n_fft = p;
  }

  std::vector<std::complex<double>> s1(n_fft, 0.0), s2(n_fft, 0.0);
  for (int i = 0; i < seg_len; ++i) {
    const double w = 0.42 - 0.5 * std::cos(2 * kPi * i / (seg_len - 1)) +
                     0.08 * std::cos(4 * kPi * i / (seg_len - 1));
    s1[i] = x[lo + i] * w;
    s2[i] = x[lo + 1 + i] * w;
  }
  fft_inplace(s1);
  fft_inplace(s2);

  double num = 0.0, den = 0.0;
  for (int k = 1; k <= 6; ++k) {
    const double fk_hz = k * f0_init;
    if (fk_hz >= fs / 2.0 - f0_init / 2.0) break;
    const int bin = static_cast<int>(std::lround(fk_hz * n_fft / fs));
    if (bin >= static_cast<int>(n_fft / 2 + 1)) break;
    const std::complex<double> a = s1[bin];
    const std::complex<double> b = s2[bin];
    const double dphi = std::arg(b * std::conj(a));
    const double inst_f = dphi * fs / (2 * kPi);
    const double amp = std::abs(a);
    if (inst_f > 0) {
      num += amp * inst_f / k;
      den += amp;
    }
  }
  if (den <= 0) return f0_init;
  const double refined = num / den;
  if (std::abs(refined - f0_init) / f0_init > 0.2) return f0_init;
  return refined;
}

}  // namespace

extern "C" {

// f0_out must hold at least (int)(n / fs * 1000 / frame_period_ms) + 1 values.
// Returns the number of frames written.
int32_t alive_dio_stonemask(const float* x_in, int32_t n, int32_t fs,
                            double f0_floor, double f0_ceil,
                            double frame_period_ms, double channels_in_octave,
                            double allowed_range, double* f0_out) {
  std::vector<double> x(x_in, x_in + n);
  f0_ceil = std::min(f0_ceil, fs / 2.0 * 0.9);
  const int n_frames =
      static_cast<int>(n / static_cast<double>(fs) * 1000.0 / frame_period_ms) + 1;
  std::vector<double> frame_t(n_frames);
  for (int i = 0; i < n_frames; ++i) frame_t[i] = i * frame_period_ms / 1000.0;

  const int n_bands = static_cast<int>(std::ceil(
                          std::log2(f0_ceil / f0_floor) * channels_in_octave)) + 1;
  std::vector<double> best_f0(n_frames, 0.0);
  std::vector<double> best_dev(n_frames, 1e30);
  std::vector<std::vector<double>> cand_f0(n_bands,
                                           std::vector<double>(n_frames, 0.0));

  for (int b = 0; b < n_bands; ++b) {
    const double boundary =
        f0_floor * std::pow(2.0, (b + 1) / channels_in_octave);
    const auto h = nuttall_lowpass(boundary, fs);
    const auto y = fir_same(x, h);

    std::vector<std::vector<double>> cands;
    bool ok = true;
    for (int kind = 0; kind < 4; ++kind) {
      const Events ev = event_intervals(y, fs, static_cast<EventKind>(kind));
      if (ev.centers.size() < 2) { ok = false; break; }
      cands.push_back(interp_to_frames(ev, frame_t));
    }
    if (!ok) continue;

    for (int i = 0; i < n_frames; ++i) {
      double mean = 0.0;
      for (int c = 0; c < 4; ++c) mean += cands[c][i];
      mean /= 4.0;
      double var = 0.0;
      for (int c = 0; c < 4; ++c) {
        const double d = cands[c][i] - mean;
        var += d * d;
      }
      const double dev = std::sqrt(var / 4.0);
      const double rel = (mean > 0) ? dev / std::max(mean, 1e-12) : 1e30;
      const bool in_range = mean > std::max(f0_floor, boundary / 4.0) &&
                            mean < std::min(f0_ceil, boundary * 1.1);
      if (in_range) cand_f0[b][i] = mean;
      const double score = in_range ? rel : 1e30;
      if (score < best_dev[i]) {
        best_f0[i] = mean;
        best_dev[i] = score;
      }
    }
  }

  std::vector<double> f0(n_frames);
  for (int i = 0; i < n_frames; ++i) {
    f0[i] = (best_dev[i] < allowed_range) ? best_f0[i] : 0.0;
  }
  fix_f0_contour(f0, cand_f0, allowed_range);
  for (int i = 0; i < n_frames; ++i) {
    // two StoneMask refinement passes (matching ops/world.py stonemask)
    f0_out[i] =
        refine_frame(x, fs, frame_t[i], refine_frame(x, fs, frame_t[i], f0[i]));
  }
  return n_frames;
}

// Batched, threaded labeler for dataset preparation: items are independent
// (alive_dio_stonemask uses only locals), so shard them over a worker pool.
// x: [n_items, item_len] row-major; f0_out: [n_items, frames_per_item]
// row-major with frames_per_item = item_len/fs*1000/frame_period + 1.
// Returns frames_per_item (same for every item), or -1 on bad args.
int32_t alive_dio_stonemask_batch(const float* x, int32_t n_items,
                                  int32_t item_len, int32_t fs,
                                  double f0_floor, double f0_ceil,
                                  double frame_period_ms,
                                  double channels_in_octave,
                                  double allowed_range, double* f0_out,
                                  int32_t n_threads) {
  if (n_items <= 0 || item_len <= 0) return -1;
  const int frames = static_cast<int>(
      item_len / static_cast<double>(fs) * 1000.0 / frame_period_ms) + 1;
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int32_t>(n_threads, n_items);
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    for (;;) {
      const int32_t i = next.fetch_add(1);
      if (i >= n_items) break;
      alive_dio_stonemask(x + static_cast<int64_t>(i) * item_len, item_len,
                          fs, f0_floor, f0_ceil, frame_period_ms,
                          channels_in_octave, allowed_range,
                          f0_out + static_cast<int64_t>(i) * frames);
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return frames;
}

}  // extern "C"
