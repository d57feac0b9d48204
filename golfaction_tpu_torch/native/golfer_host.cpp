// Host-side runtime of golfaction_tpu_torch: motion-energy person boxes over
// raw 1080p frames and batch pixel-format conversion, multithreaded.
//
// A copy of the JAX package's golfaction_tpu/native/golfer_host.cpp (the
// port imports nothing of that package), so that the port's default boxes
// are the ones the JAX pipeline computes; tests/test_torch_native.py holds
// the two libraries to each other exactly and to the numpy body of
// pipeline/video_io.py within 1 px.
//
// Exposed as a C ABI for ctypes.  Built at first use by ops/_kernels.py:
// g++ -O3 -shared -fPIC -pthread -std=c++17, into golfaction_tpu_torch/build/.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : static_cast<int>(n);
}

// Run fn(begin, end) over [0, total) split across threads.
template <typename F>
void parallel_for(int64_t total, F fn) {
  int nt = std::min<int64_t>(hardware_threads(), std::max<int64_t>(total, 1));
  if (nt <= 1) {
    fn(0, total);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (total + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min<int64_t>(b + chunk, total);
    if (b >= e) break;
    threads.emplace_back([=] { fn(b, e); });
  }
  for (auto& th : threads) th.join();
}

// np.percentile(values, q) with linear interpolation, where `values` is the
// multiset {coord c repeated hist[c] times}, hist over [0, n).
double percentile_from_hist(const std::vector<int64_t>& hist, int64_t count,
                            double q) {
  if (count <= 0) return 0.0;
  double rank = (count - 1) * q / 100.0;
  int64_t lo_rank = static_cast<int64_t>(std::floor(rank));
  double frac = rank - lo_rank;
  int64_t cum = 0;
  int n = static_cast<int>(hist.size());
  int lo_val = -1, hi_val = -1;
  for (int c = 0; c < n; ++c) {
    cum += hist[c];
    if (lo_val < 0 && cum > lo_rank) lo_val = c;
    if (cum > lo_rank + 1) { hi_val = c; break; }
  }
  if (lo_val < 0) lo_val = n - 1;
  if (hi_val < 0) hi_val = lo_val;  // lo_rank+1 == count → last element
  return lo_val + frac * (hi_val - lo_val);
}

}  // namespace

extern "C" {

// Motion-energy person boxes for a static-camera clip.
// frames: [T, H, W, 3] uint8 (RGB or BGR — only intensity is used).
// boxes_out: [T, 4] float32 (cx, cy, w, h).
// Mirrors video_io.estimate_person_boxes: median background over T,
// threshold max(12, mean+std), per-frame 1/99 coordinate percentiles,
// 1.1x expansion, min-size floor, temporal median smoothing.
void motion_boxes(const uint8_t* frames, int64_t T, int64_t H, int64_t W,
                  float min_size, int smooth, float* boxes_out) {
  const int64_t HW = H * W;

  // Per-pixel intensity, stored [T, HW] as float32 (gray = mean of channels).
  std::vector<float> gray(static_cast<size_t>(T) * HW);
  parallel_for(T * HW, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      const uint8_t* p = frames + i * 3;
      gray[i] = (static_cast<float>(p[0]) + p[1] + p[2]) * (1.0f / 3.0f);
    }
  });

  // Median background per pixel over T.
  std::vector<float> background(HW);
  parallel_for(HW, [&](int64_t b, int64_t e) {
    std::vector<float> tmp(T);
    for (int64_t px = b; px < e; ++px) {
      for (int64_t t = 0; t < T; ++t) tmp[t] = gray[t * HW + px];
      int64_t mid = T / 2;
      std::nth_element(tmp.begin(), tmp.begin() + mid, tmp.end());
      float m = tmp[mid];
      if (T % 2 == 0) {
        // NumPy median: average of the two middle elements.
        float lo = *std::max_element(tmp.begin(), tmp.begin() + mid);
        m = 0.5f * (lo + m);
      }
      background[px] = m;
    }
  });

  // Energy statistics for the threshold: mean and std over all T*HW.
  std::vector<double> partial_sum(hardware_threads(), 0.0);
  std::vector<double> partial_sq(hardware_threads(), 0.0);
  {
    std::atomic<int> tid{0};
    parallel_for(T, [&](int64_t b, int64_t e) {
      int id = tid.fetch_add(1);
      double s = 0.0, s2 = 0.0;
      for (int64_t t = b; t < e; ++t)
        for (int64_t px = 0; px < HW; ++px) {
          double v = std::fabs(gray[t * HW + px] - background[px]);
          s += v;
          s2 += v * v;
        }
      partial_sum[id] += s;
      partial_sq[id] += s2;
    });
  }
  double total = 0, total_sq = 0;
  for (size_t i = 0; i < partial_sum.size(); ++i) {
    total += partial_sum[i];
    total_sq += partial_sq[i];
  }
  double n = static_cast<double>(T) * HW;
  double mean = total / n;
  double var = std::max(total_sq / n - mean * mean, 0.0);
  float thresh = std::max(12.0, mean + std::sqrt(var));

  // Per-frame column/row histograms of above-threshold pixels → percentiles.
  std::vector<float> raw(static_cast<size_t>(T) * 4);
  const float fb_cx = W / 2.0f, fb_cy = H / 2.0f;
  const float fb_w = W * 0.5f, fb_h = H * 0.9f;
  parallel_for(T, [&](int64_t b, int64_t e) {
    std::vector<int64_t> colh(W), rowh(H);
    for (int64_t t = b; t < e; ++t) {
      std::fill(colh.begin(), colh.end(), 0);
      std::fill(rowh.begin(), rowh.end(), 0);
      int64_t count = 0;
      const float* g = &gray[t * HW];
      for (int64_t y = 0; y < H; ++y)
        for (int64_t x = 0; x < W; ++x)
          if (std::fabs(g[y * W + x] - background[y * W + x]) > thresh) {
            ++colh[x];
            ++rowh[y];
            ++count;
          }
      float* box = &raw[t * 4];
      if (count < 50) {
        box[0] = fb_cx; box[1] = fb_cy; box[2] = fb_w; box[3] = fb_h;
        continue;
      }
      double x0 = percentile_from_hist(colh, count, 1.0);
      double x1 = percentile_from_hist(colh, count, 99.0);
      double y0 = percentile_from_hist(rowh, count, 1.0);
      double y1 = percentile_from_hist(rowh, count, 99.0);
      double w = std::max(x1 - x0, static_cast<double>(min_size) * W);
      double h = std::max(y1 - y0, static_cast<double>(min_size) * H);
      box[0] = static_cast<float>((x0 + x1) / 2);
      box[1] = static_cast<float>((y0 + y1) / 2);
      box[2] = static_cast<float>(w * 1.1);
      box[3] = static_cast<float>(h * 1.1);
    }
  });

  // Temporal median smoothing (window k, edge-padded), matching the NumPy
  // reference: k = min(smooth, T odd-ified), median per coordinate.
  int k = smooth;
  if (k > 1 && T > 1) {
    k = std::min<int64_t>(k, (T % 2) ? T : T - 1);
    int pad = k / 2;
    parallel_for(T, [&](int64_t b, int64_t e) {
      std::vector<float> window(k);
      for (int64_t t = b; t < e; ++t)
        for (int c = 0; c < 4; ++c) {
          for (int j = 0; j < k; ++j) {
            int64_t src = std::clamp<int64_t>(t - pad + j, 0, T - 1);
            window[j] = raw[src * 4 + c];
          }
          int mid = k / 2;
          std::nth_element(window.begin(), window.begin() + mid, window.end());
          float m = window[mid];
          if (k % 2 == 0) {
            float lo = *std::max_element(window.begin(), window.begin() + mid);
            m = 0.5f * (lo + m);
          }
          boxes_out[t * 4 + c] = m;
        }
    });
  } else {
    std::memcpy(boxes_out, raw.data(), sizeof(float) * T * 4);
  }
}

// Batch BGR→RGB (or any channel swap 2↔0) conversion, multithreaded.
// In-place safe only when src != dst.
void bgr_to_rgb(const uint8_t* src, int64_t n_pixels, uint8_t* dst) {
  parallel_for(n_pixels, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      const uint8_t* s = src + i * 3;
      uint8_t* d = dst + i * 3;
      uint8_t b0 = s[0], g = s[1], r = s[2];
      d[0] = r; d[1] = g; d[2] = b0;
    }
  });
}

int golfer_host_version() { return 1; }

}  // extern "C"
