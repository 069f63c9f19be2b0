// Native pitch extraction: RAPT-style NCCF + Viterbi tracker, and YIN.
//
// Role parity: the reference preprocess uses pysptk's C implementations of
// RAPT and SWIPE as a median ensemble (reference
// kantts/preprocess/audio_processor/core/utils.py:288-368). pysptk is not
// available here, so this file provides two INDEPENDENT in-tree native
// estimators with the same call contract (frame-rate f0, 0 = unvoiced):
//   - rapt_pitch: normalized cross-correlation candidates + dynamic
//     programming over voicing transitions (RAPT's core recipe, Talkin 1995)
//   - yin_pitch: cumulative-mean-normalized difference function with
//     parabolic refinement (de Cheveigne & Kawahara 2002)
//
// Build: g++ -O3 -march=native -shared -fPIC pitch.cpp -o libkantts_pitch.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Candidate {
  int lag;        // 0 = unvoiced candidate
  float score;    // NCCF value (unvoiced: small constant)
};

// NCCF over window [start, start+wlen) at the given lag.
inline float nccf_at(const float* x, int n, int start, int wlen, int lag) {
  double e1 = 1e-12, e2 = 1e-12, cc = 0.0;
  const int s2 = start + lag;
  if (s2 + wlen > n || start < 0) return 0.0f;
  for (int i = 0; i < wlen; ++i) {
    const double a = x[start + i];
    const double b = x[s2 + i];
    e1 += a * a;
    e2 += b * b;
    cc += a * b;
  }
  return static_cast<float>(cc / std::sqrt(e1 * e2));
}

}  // namespace

extern "C" {

// Returns number of frames written to f0_out (frame t covers samples
// [t*hop, t*hop + window)). f0_out[t] == 0 -> unvoiced.
int rapt_pitch(const float* x, int n, int sr, int hop,
               float min_f0, float max_f0, float* f0_out, int max_frames) {
  if (n <= 0 || sr <= 0 || hop <= 0 || min_f0 <= 0 || max_f0 <= min_f0)
    return 0;
  const int lag_min = std::max(2, static_cast<int>(sr / max_f0));
  const int lag_max = std::min(n - 1, static_cast<int>(sr / min_f0));
  if (lag_max <= lag_min) return 0;
  const int wlen = std::max(lag_min * 2, sr / 100);  // >= 10 ms correlation win
  const int n_frames =
      std::min(max_frames, std::max(0, n / hop));
  if (n_frames == 0) return 0;

  // remove DC once
  std::vector<float> sig(x, x + n);
  double mean = 0.0;
  for (int i = 0; i < n; ++i) mean += sig[i];
  mean /= n;
  for (int i = 0; i < n; ++i) sig[i] -= static_cast<float>(mean);

  const int kMaxCand = 8;
  std::vector<std::vector<Candidate>> cands(n_frames);

  // coarse-to-fine: evaluate NCCF on a decimated lag grid, then refine peaks
  const int coarse_step = std::max(1, lag_min / 8);

  std::vector<float> corr(lag_max + 1, 0.0f);
  for (int t = 0; t < n_frames; ++t) {
    const int start = t * hop;
    float best_any = 0.0f;
    std::fill(corr.begin(), corr.end(), 0.0f);
    for (int lag = lag_min; lag <= lag_max; lag += coarse_step) {
      corr[lag] = nccf_at(sig.data(), n, start, wlen, lag);
      best_any = std::max(best_any, corr[lag]);
    }
    // refine around coarse maxima
    std::vector<Candidate>& fc = cands[t];
    for (int lag = lag_min; lag <= lag_max; lag += coarse_step) {
      const float c = corr[lag];
      if (c < 0.3f || c < best_any - 0.35f) continue;
      // local peak on the coarse grid? the short-lag boundary is NOT a peak
      // (a decaying autocorrelation tail there is spurious); the long-lag
      // boundary stays permissive for f0 at the range edge
      const float left = (lag - coarse_step >= lag_min) ? corr[lag - coarse_step] : 2.f;
      const float right = (lag + coarse_step <= lag_max) ? corr[lag + coarse_step] : -1.f;
      if (c < left || c < right) continue;
      // refine on the fine grid
      int best_lag = lag;
      float best_c = c;
      const int lo = std::max(lag_min, lag - coarse_step + 1);
      const int hi = std::min(lag_max, lag + coarse_step - 1);
      for (int l = lo; l <= hi; ++l) {
        const float cf = nccf_at(sig.data(), n, start, wlen, l);
        if (cf > best_c) { best_c = cf; best_lag = l; }
      }
      // lag-proportional penalty (RAPT's LAGWT): favors the shortest strong
      // lag so exact subharmonics of periodic signals don't win
      const float kLagWeight = 0.3f;
      const float adj = best_c * (1.0f - kLagWeight * static_cast<float>(best_lag)
                                             / static_cast<float>(lag_max));
      fc.push_back({best_lag, adj});
    }
    std::sort(fc.begin(), fc.end(),
              [](const Candidate& a, const Candidate& b) { return a.score > b.score; });
    if (static_cast<int>(fc.size()) > kMaxCand) fc.resize(kMaxCand);
    fc.push_back({0, 0.0f});  // unvoiced candidate
  }

  // Viterbi over candidates.
  const float kVoicingBias = 0.25f;   // reward for voiced when NCCF high
  const float kTransCost = 0.35f;     // octave-jump cost weight
  const float kVuvCost = 0.3f;        // voiced<->unvoiced switch cost

  std::vector<std::vector<float>> score(n_frames);
  std::vector<std::vector<int>> back(n_frames);
  for (int t = 0; t < n_frames; ++t) {
    score[t].assign(cands[t].size(), 0.0f);
    back[t].assign(cands[t].size(), 0);
  }
  for (size_t j = 0; j < cands[0].size(); ++j) {
    const Candidate& c = cands[0][j];
    score[0][j] = (c.lag > 0) ? (c.score - kVoicingBias) : 0.0f;
  }
  for (int t = 1; t < n_frames; ++t) {
    for (size_t j = 0; j < cands[t].size(); ++j) {
      const Candidate& cj = cands[t][j];
      float best = -1e30f;
      int arg = 0;
      for (size_t i = 0; i < cands[t - 1].size(); ++i) {
        const Candidate& ci = cands[t - 1][i];
        float trans;
        if (ci.lag > 0 && cj.lag > 0) {
          trans = kTransCost * std::fabs(std::log(
              static_cast<double>(ci.lag) / cj.lag));
        } else if (ci.lag == 0 && cj.lag == 0) {
          trans = 0.0f;
        } else {
          trans = kVuvCost;
        }
        const float s = score[t - 1][i] - trans;
        if (s > best) { best = s; arg = static_cast<int>(i); }
      }
      const float local = (cj.lag > 0) ? (cj.score - kVoicingBias) : 0.0f;
      score[t][j] = best + local;
      back[t][j] = arg;
    }
  }

  // backtrack
  int cur = 0;
  {
    float best = -1e30f;
    for (size_t j = 0; j < score[n_frames - 1].size(); ++j) {
      if (score[n_frames - 1][j] > best) {
        best = score[n_frames - 1][j];
        cur = static_cast<int>(j);
      }
    }
  }
  for (int t = n_frames - 1; t >= 0; --t) {
    const Candidate& c = cands[t][cur];
    f0_out[t] = (c.lag > 0) ? static_cast<float>(sr) / c.lag : 0.0f;
    if (t > 0) cur = back[t][cur];
  }
  return n_frames;
}

int yin_pitch(const float* x, int n, int sr, int hop,
              float min_f0, float max_f0, float* f0_out, int max_frames) {
  if (n <= 0 || sr <= 0 || hop <= 0 || min_f0 <= 0 || max_f0 <= min_f0)
    return 0;
  const int tau_min = std::max(2, static_cast<int>(sr / max_f0));
  const int tau_max = std::min(n - 1, static_cast<int>(sr / min_f0));
  if (tau_max <= tau_min) return 0;
  const int wlen = tau_max;  // integration window
  const int n_frames = std::min(max_frames, std::max(0, n / hop));
  const float threshold = 0.15f;

  std::vector<double> d(tau_max + 1);
  std::vector<double> cmnd(tau_max + 1);

  for (int t = 0; t < n_frames; ++t) {
    const int start = t * hop;
    if (start + wlen + tau_max >= n) {
      f0_out[t] = 0.0f;
      continue;
    }
    // difference function
    for (int tau = 1; tau <= tau_max; ++tau) {
      double acc = 0.0;
      for (int i = 0; i < wlen; ++i) {
        const double diff = x[start + i] - x[start + i + tau];
        acc += diff * diff;
      }
      d[tau] = acc;
    }
    // cumulative mean normalized difference
    double running = 0.0;
    cmnd[0] = 1.0;
    for (int tau = 1; tau <= tau_max; ++tau) {
      running += d[tau];
      cmnd[tau] = (running > 0.0) ? d[tau] * tau / running : 1.0;
    }
    // absolute threshold
    int tau_est = -1;
    for (int tau = tau_min; tau <= tau_max; ++tau) {
      if (cmnd[tau] < threshold) {
        while (tau + 1 <= tau_max && cmnd[tau + 1] < cmnd[tau]) ++tau;
        tau_est = tau;
        break;
      }
    }
    if (tau_est < 0) {
      // fall back to global minimum if it is convincing
      int arg = tau_min;
      for (int tau = tau_min; tau <= tau_max; ++tau)
        if (cmnd[tau] < cmnd[arg]) arg = tau;
      if (cmnd[arg] < 0.35) tau_est = arg;
    }
    if (tau_est < 0) {
      f0_out[t] = 0.0f;
      continue;
    }
    // parabolic interpolation
    double tau_ref = tau_est;
    if (tau_est > tau_min && tau_est < tau_max) {
      const double s0 = cmnd[tau_est - 1], s1 = cmnd[tau_est], s2 = cmnd[tau_est + 1];
      const double denom = 2.0 * (2.0 * s1 - s0 - s2);
      if (std::fabs(denom) > 1e-12) tau_ref = tau_est + (s2 - s0) / denom;
    }
    f0_out[t] = static_cast<float>(sr / tau_ref);
  }
  return n_frames;
}

}  // extern "C"
