// Native host-side data-pipeline core of css_tpu_torch: the port's own copy
// of css_tpu/native/mixcore.cpp, with the same C entry points, ABI version
// and arithmetic. css_tpu_torch/ops/native.py builds it with g++ at first
// use into css_tpu_torch/_build/ and binds it with ctypes.
//
// Mixture synthesis is the host's hot loop when training (the mixer and
// the augmentations, css_tpu_torch/data/). This library runs its three
// hot spots so that one producer thread keeps the card fed:
//
//   * mix_and_window / mix_and_window_k: place the utterances on the
//     mixture timeline, mix, and emit equal windows of the mixture and the
//     sources in one cache-friendly pass
//   * fft_convolve_trunc: RIR reverberation via radix-2 FFT convolution,
//     truncated to the input length, with output energy normalization
//     (lhotse ReverbWithImpulseResponse semantics)
//   * add_noise_snr: tile/trim a noise cut and add it at a target SNR
//     (lhotse CutMix semantics)
//
// A plain C ABI for ctypes; ctypes releases the GIL for the duration of
// each call, so several python producer threads scale.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

using cfloat = std::complex<float>;

// iterative radix-2 Cooley-Tukey, in-place, n must be a power of two
void fft_inplace(cfloat* a, int64_t n, bool inverse) {
  // bit reversal
  for (int64_t i = 1, j = 0; i < n; ++i) {
    int64_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (int64_t len = 2; len <= n; len <<= 1) {
    const double ang = 2.0 * M_PI / double(len) * (inverse ? 1.0 : -1.0);
    const cfloat wlen(std::cos(ang), std::sin(ang));
    for (int64_t i = 0; i < n; i += len) {
      cfloat w(1.0f, 0.0f);
      for (int64_t k = 0; k < len / 2; ++k) {
        const cfloat u = a[i + k];
        const cfloat v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (inverse) {
    const float inv = 1.0f / float(n);
    for (int64_t i = 0; i < n; ++i) a[i] *= inv;
  }
}

int64_t next_pow2(int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Pad w1 right / w2 both sides to the mixture length, mix, and cut the
// first num_windows equal windows (css/datasets/separation.py:200-231).
// Outputs are (num_windows, win) row-major float32.
void mix_and_window(const float* w1, int64_t n1, const float* w2, int64_t n2,
                    int64_t offset, int64_t win, int64_t num_windows,
                    float* mix_out, float* s1_out, float* s2_out) {
  const int64_t total = num_windows * win;
  for (int64_t t = 0; t < total; ++t) {
    const float a = (t < n1) ? w1[t] : 0.0f;
    const float b = (t >= offset && t - offset < n2) ? w2[t - offset] : 0.0f;
    s1_out[t] = a;
    s2_out[t] = b;
    mix_out[t] = a + b;
  }
}

// K-speaker generalization: `waves` holds the K utterances concatenated
// (lengths in `lens`), each placed at sample offset `offs[i]` of the
// mixture timeline. Emits mix (num_windows, win) and the K padded
// sources stacked as (K, num_windows, win), all row-major float32.
void mix_and_window_k(const float* waves, const int64_t* lens,
                      const int64_t* offs, int64_t k, int64_t win,
                      int64_t num_windows, float* mix_out, float* src_out) {
  const int64_t total = num_windows * win;
  std::memset(mix_out, 0, size_t(total) * sizeof(float));
  const float* w = waves;
  float* s = src_out;
  for (int64_t i = 0; i < k; ++i) {
    const int64_t o = offs[i], n = lens[i];
    const int64_t lo = std::min(std::max<int64_t>(o, 0), total);
    const int64_t hi = std::min(o + n, total);
    std::memset(s, 0, size_t(lo) * sizeof(float));
    for (int64_t t = lo; t < hi; ++t) {
      const float v = w[t - o];
      s[t] = v;
      mix_out[t] += v;
    }
    if (hi < total)
      std::memset(s + std::max<int64_t>(hi, 0), 0,
                  size_t(total - std::max<int64_t>(hi, 0)) * sizeof(float));
    w += n;
    s += total;
  }
}

namespace {

// cached RIR spectra, keyed by (caller-stable rir_id, nfft)
std::mutex g_rir_mutex;
std::unordered_map<uint64_t, std::vector<cfloat>> g_rir_cache;

const std::vector<cfloat>& rir_spectrum(const float* h, int64_t m,
                                        int64_t rir_id, int64_t nfft) {
  const uint64_t key = (uint64_t(rir_id) << 32) ^ uint64_t(nfft);
  std::lock_guard<std::mutex> lock(g_rir_mutex);
  auto it = g_rir_cache.find(key);
  if (it != g_rir_cache.end()) return it->second;
  std::vector<cfloat> fh(nfft, cfloat(0, 0));
  for (int64_t i = 0; i < m; ++i) fh[i] = cfloat(h[i], 0);
  fft_inplace(fh.data(), nfft, false);
  return g_rir_cache.emplace(key, std::move(fh)).first->second;
}

void convolve_common(const float* x, int64_t n, const cfloat* fh,
                     int64_t nfft, int32_t normalize, float* out) {
  std::vector<cfloat> fx(nfft, cfloat(0, 0));
  for (int64_t i = 0; i < n; ++i) fx[i] = cfloat(x[i], 0);
  fft_inplace(fx.data(), nfft, false);
  for (int64_t i = 0; i < nfft; ++i) fx[i] *= fh[i];
  fft_inplace(fx.data(), nfft, true);
  double in_e = 0.0, out_e = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = fx[i].real();
    in_e += double(x[i]) * double(x[i]);
    out_e += double(out[i]) * double(out[i]);
  }
  if (normalize) {
    const double scale =
        std::sqrt((in_e / double(n) + 1e-16) / (out_e / double(n) + 1e-16));
    for (int64_t i = 0; i < n; ++i) out[i] *= float(scale);
  }
}

}  // namespace

// y = (x * h)[:n], energy-normalized to the input energy when
// normalize != 0. Uses radix-2 FFT convolution.
void fft_convolve_trunc(const float* x, int64_t n, const float* h, int64_t m,
                        int32_t normalize, float* out) {
  const int64_t nfft = next_pow2(n + m - 1);
  std::vector<cfloat> fh(nfft, cfloat(0, 0));
  for (int64_t i = 0; i < m; ++i) fh[i] = cfloat(h[i], 0);
  fft_inplace(fh.data(), nfft, false);
  convolve_common(x, n, fh.data(), nfft, normalize, out);
}

// Same, but the RIR spectrum is cached under a caller-stable rir_id —
// the augmentation RIR pool is fixed, so each (rir, nfft) pays its
// forward FFT exactly once per process.
void fft_convolve_trunc_cached(const float* x, int64_t n, const float* h,
                               int64_t m, int64_t rir_id, int32_t normalize,
                               float* out) {
  const int64_t nfft = next_pow2(n + m - 1);
  const auto& fh = rir_spectrum(h, m, rir_id, nfft);
  convolve_common(x, n, fh.data(), nfft, normalize, out);
}

// wav += scale(snr) * tiled(noise from start); in-place.
void add_noise_snr(float* wav, int64_t n, const float* noise, int64_t nn,
                   int64_t start, float snr_db) {
  double sig_p = 0.0;
  for (int64_t i = 0; i < n; ++i) sig_p += double(wav[i]) * double(wav[i]);
  sig_p = sig_p / double(n) + 1e-12;
  double noi_p = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const float v = noise[(start + i) % nn];
    noi_p += double(v) * double(v);
  }
  noi_p = noi_p / double(n) + 1e-12;
  const float scale =
      float(std::sqrt(sig_p / (noi_p * std::pow(10.0, snr_db / 10.0))));
  for (int64_t i = 0; i < n; ++i) wav[i] += scale * noise[(start + i) % nn];
}

int32_t mixcore_abi_version() { return 3; }

}  // extern "C"
