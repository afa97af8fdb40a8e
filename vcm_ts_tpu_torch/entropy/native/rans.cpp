// vcm_ts_tpu_torch native entropy-coding layer (a copy of the JAX package's coder; the stream format is shared).
//
// A 64-bit range Asymmetric Numeral System (rANS) encoder/decoder plus a
// PMF -> quantized-CDF converter, exposed through a plain C ABI consumed by
// ctypes (see ../rans.py). This is the TPU-native equivalent of the
// reference's MLCodec_rans / MLCodec_CXX pybind11 modules
// (reference: DCVC_HEM/src/cpp/rans/rans_interface.cpp:85-244,
//  DCVC_HEM/src/cpp/ops/ops.cpp:24-82). It implements the same bitstream
// format (16-bit probability precision, 4-bit bypass escape coding for
// out-of-range symbols) so that streams written by the encoder are decodable
// by the decoder bit-exactly; the code itself is written from scratch around
// the public rans64 construction (Duda's rANS; Giesen's rans64 streaming
// variant).
//
// Everything here runs on the host CPU, interleaved with TPU compute: the
// TPU produces int32 symbol/index planes, this layer turns them into bytes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ----------------------------------------------------------------------------
// rans64 core
// ----------------------------------------------------------------------------

using Rans64State = uint64_t;

// Lower bound of the normalized interval. State always stays in
// [RANS64_L, (RANS64_L >> PROB_BITS) << 32 * freq) during encoding.
constexpr uint64_t RANS64_L = 1ull << 31;

constexpr int PROB_BITS = 16;                 // probability precision
constexpr uint32_t PROB_SCALE = 1u << PROB_BITS;
constexpr uint32_t BYPASS_BITS = 4;           // raw-bit escape chunk size
constexpr uint32_t MAX_BYPASS_VAL = (1u << BYPASS_BITS) - 1;

inline void rans64_enc_init(Rans64State* r) { *r = RANS64_L; }

// Encode one symbol occupying [start, start+freq) of the 2^16 interval.
// Words are emitted back-to-front: *pptr walks down.
inline void rans64_enc_put(Rans64State* r, uint32_t** pptr, uint32_t start,
                           uint32_t freq, uint32_t prec) {
  uint64_t x = *r;
  const uint64_t x_max = ((RANS64_L >> prec) << 32) * freq;
  if (x >= x_max) {
    *pptr -= 1;
    **pptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
  *r = ((x / freq) << prec) + (x % freq) + start;
}

inline void rans64_enc_flush(Rans64State* r, uint32_t** pptr) {
  const uint64_t x = *r;
  *pptr -= 2;
  (*pptr)[0] = static_cast<uint32_t>(x >> 0);
  (*pptr)[1] = static_cast<uint32_t>(x >> 32);
}

inline void rans64_dec_init(Rans64State* r, uint32_t** pptr) {
  uint64_t x = static_cast<uint64_t>((*pptr)[0]) << 0;
  x |= static_cast<uint64_t>((*pptr)[1]) << 32;
  *pptr += 2;
  *r = x;
}

// Peek the cumulative-frequency slot of the next symbol.
inline uint32_t rans64_dec_get(Rans64State* r, uint32_t prec) {
  return static_cast<uint32_t>(*r & ((1ull << prec) - 1));
}

// Consume the symbol occupying [start, start+freq).
inline void rans64_dec_advance(Rans64State* r, uint32_t** pptr, uint32_t start,
                               uint32_t freq, uint32_t prec) {
  const uint64_t mask = (1ull << prec) - 1;
  uint64_t x = *r;
  x = freq * (x >> prec) + (x & mask) - start;
  if (x < RANS64_L) {
    x = (x << 32) | **pptr;
    *pptr += 1;
  }
  *r = x;
}

// Raw-bit ("bypass") coding for escape values, nbits <= 16.
inline void rans64_enc_put_bits(Rans64State* r, uint32_t** pptr, uint32_t val,
                                uint32_t nbits) {
  uint64_t x = *r;
  const uint32_t freq = 1u << (16 - nbits);
  const uint64_t x_max = ((RANS64_L >> 16) << 32) * freq;
  if (x >= x_max) {
    *pptr -= 1;
    **pptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
  *r = (x << nbits) | val;
}

inline uint32_t rans64_dec_get_bits(Rans64State* r, uint32_t** pptr,
                                    uint32_t nbits) {
  uint64_t x = *r;
  const uint32_t val = static_cast<uint32_t>(x & ((1ull << nbits) - 1));
  x >>= nbits;
  if (x < RANS64_L) {
    x = (x << 32) | **pptr;
    *pptr += 1;
  }
  *r = x;
  return val;
}

// ----------------------------------------------------------------------------
// Buffered encoder / streaming decoder
// ----------------------------------------------------------------------------

struct RansSymbol {
  uint16_t start;
  uint16_t range;  // freq for normal symbols; unused width for bypass
  bool bypass;     // raw-bit escape chunk
};

struct Encoder {
  std::vector<RansSymbol> syms;
};

struct Decoder {
  std::string stream;
  uint32_t* ptr = nullptr;
  Rans64State rans = 0;
};

// Map (symbol - offset) into the finite CDF alphabet; out-of-range values are
// folded onto the escape slot (max_value) and their overflow carried as a
// variable-length raw value in 4-bit chunks. Mirrors the reference escape
// protocol (rans_interface.cpp:104-143) so bitstreams are format-compatible.
inline void buffer_symbol(Encoder* e, int32_t value, const int32_t* cdf,
                          int32_t max_value) {
  // 64-bit so the chunk-count shift below stays defined for raw_val >= 2^28
  // (a uint32 here would shift by 32 — UB — and hang on extreme symbols).
  uint64_t raw_val = 0;
  if (value < 0) {
    raw_val = -2ll * value - 1;
    value = max_value;
  } else if (value >= max_value) {
    raw_val = 2ll * (value - max_value);
    value = max_value;
  }

  e->syms.push_back({static_cast<uint16_t>(cdf[value]),
                     static_cast<uint16_t>(cdf[value + 1] - cdf[value]),
                     false});

  if (value == max_value) {
    int32_t n_bypass = 0;
    while ((raw_val >> (n_bypass * BYPASS_BITS)) != 0) ++n_bypass;

    int32_t val = n_bypass;
    while (val >= static_cast<int32_t>(MAX_BYPASS_VAL)) {
      e->syms.push_back({static_cast<uint16_t>(MAX_BYPASS_VAL),
                         static_cast<uint16_t>(MAX_BYPASS_VAL + 1), true});
      val -= MAX_BYPASS_VAL;
    }
    e->syms.push_back(
        {static_cast<uint16_t>(val), static_cast<uint16_t>(val + 1), true});

    for (int32_t j = 0; j < n_bypass; ++j) {
      const int32_t chunk = (raw_val >> (j * BYPASS_BITS)) & MAX_BYPASS_VAL;
      e->syms.push_back({static_cast<uint16_t>(chunk),
                         static_cast<uint16_t>(chunk + 1), true});
    }
  }
}

}  // namespace

extern "C" {

// ------------------------------- encoder -----------------------------------

void* vcm_rans_enc_create() { return new Encoder(); }

void vcm_rans_enc_destroy(void* enc) { delete static_cast<Encoder*>(enc); }

void vcm_rans_enc_reset(void* enc) { static_cast<Encoder*>(enc)->syms.clear(); }

// symbols/indexes: n int32 values. cdfs: row-major [n_cdfs, cdf_cols] int32.
// cdf_sizes/offsets: per-row valid length and symbol offset.
void vcm_rans_enc_encode_with_indexes(void* enc, const int32_t* symbols,
                                      const int32_t* indexes, int64_t n,
                                      const int32_t* cdfs, int64_t cdf_cols,
                                      const int32_t* cdf_sizes,
                                      const int32_t* offsets) {
  Encoder* e = static_cast<Encoder*>(enc);
  e->syms.reserve(e->syms.size() + static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t cdf_idx = indexes[i];
    const int32_t* cdf = cdfs + cdf_idx * cdf_cols;
    const int32_t max_value = cdf_sizes[cdf_idx] - 2;
    buffer_symbol(e, symbols[i] - offsets[cdf_idx], cdf, max_value);
  }
}

// Upper bound (in bytes) on the buffer needed by vcm_rans_enc_flush.
int64_t vcm_rans_enc_flush_bound(void* enc) {
  return static_cast<int64_t>(
             static_cast<Encoder*>(enc)->syms.size() + 4) * sizeof(uint32_t);
}

// Encodes buffered symbols in LIFO order, returns the byte count written to
// `out` (stream is left-aligned in `out`). Does not clear the buffer.
int64_t vcm_rans_enc_flush(void* enc, uint8_t* out, int64_t capacity) {
  Encoder* e = static_cast<Encoder*>(enc);
  Rans64State rans;
  rans64_enc_init(&rans);

  std::vector<uint32_t> scratch(e->syms.size() + 4, 0);
  uint32_t* ptr = scratch.data() + scratch.size();

  for (auto it = e->syms.rbegin(); it != e->syms.rend(); ++it) {
    if (!it->bypass) {
      rans64_enc_put(&rans, &ptr, it->start, it->range, PROB_BITS);
    } else {
      rans64_enc_put_bits(&rans, &ptr, it->start, BYPASS_BITS);
    }
  }
  rans64_enc_flush(&rans, &ptr);

  const int64_t nbytes =
      (scratch.data() + scratch.size() - ptr) * static_cast<int64_t>(sizeof(uint32_t));
  if (nbytes > capacity) return -1;
  std::memcpy(out, ptr, static_cast<size_t>(nbytes));
  return nbytes;
}

// ------------------------------- decoder -----------------------------------

void* vcm_rans_dec_create() { return new Decoder(); }

void vcm_rans_dec_destroy(void* dec) { delete static_cast<Decoder*>(dec); }

void vcm_rans_dec_set_stream(void* dec, const uint8_t* data, int64_t nbytes) {
  Decoder* d = static_cast<Decoder*>(dec);
  d->stream.assign(reinterpret_cast<const char*>(data),
                   static_cast<size_t>(nbytes));
  d->ptr = reinterpret_cast<uint32_t*>(d->stream.data());
  rans64_dec_init(&d->rans, &d->ptr);
}

void vcm_rans_dec_decode_stream(void* dec, const int32_t* indexes, int64_t n,
                                const int32_t* cdfs, int64_t cdf_cols,
                                const int32_t* cdf_sizes,
                                const int32_t* offsets, int32_t* out) {
  Decoder* d = static_cast<Decoder*>(dec);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t cdf_idx = indexes[i];
    const int32_t* cdf = cdfs + cdf_idx * cdf_cols;
    const int32_t size = cdf_sizes[cdf_idx];
    const int32_t max_value = size - 2;
    const uint32_t cum_freq = rans64_dec_get(&d->rans, PROB_BITS);

    // Binary search for the symbol slot: cdf is strictly increasing, find the
    // largest s with cdf[s] <= cum_freq. (Reference uses linear scan.)
    const int32_t* it =
        std::upper_bound(cdf, cdf + size, static_cast<int32_t>(cum_freq));
    int32_t value = static_cast<int32_t>(it - cdf) - 1;

    rans64_dec_advance(&d->rans, &d->ptr, cdf[value],
                       cdf[value + 1] - cdf[value], PROB_BITS);

    if (value == max_value) {
      // Bypass escape: read chunk count, then the raw value.
      int32_t val = rans64_dec_get_bits(&d->rans, &d->ptr, BYPASS_BITS);
      int32_t n_bypass = val;
      while (val == static_cast<int32_t>(MAX_BYPASS_VAL)) {
        val = rans64_dec_get_bits(&d->rans, &d->ptr, BYPASS_BITS);
        n_bypass += val;
      }
      int64_t raw_val = 0;
      for (int32_t j = 0; j < n_bypass; ++j) {
        val = rans64_dec_get_bits(&d->rans, &d->ptr, BYPASS_BITS);
        raw_val |= static_cast<int64_t>(val) << (j * BYPASS_BITS);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }

    out[i] = value + offsets[cdf_idx];
  }
}

// --------------------------- CDF quantization -------------------------------

// Convert a float PMF (length n) into an integer CDF (length n+1) at the
// given precision, guaranteeing every symbol at least frequency 1 by
// stealing from the richest-available low-frequency neighbour.
// Functional equivalent of the reference's pmf_to_quantized_cdf
// (DCVC_HEM/src/cpp/ops/ops.cpp:24-82).
int32_t vcm_pmf_to_quantized_cdf(const float* pmf, int64_t n, int32_t precision,
                                 uint32_t* out_cdf /* n+1 entries */) {
  if (n <= 0) return -1;
  std::vector<uint32_t> cdf(static_cast<size_t>(n) + 1);
  cdf[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float p = pmf[i] > 0.f ? pmf[i] : 0.f;
    cdf[i + 1] = static_cast<uint32_t>(
        p * static_cast<float>(1u << precision) + 0.5f);
  }

  uint64_t total = 0;
  for (auto v : cdf) total += v;
  if (total == 0) {
    // Degenerate PMF: fall back to uniform.
    for (int64_t i = 0; i <= n; ++i) {
      out_cdf[i] = static_cast<uint32_t>((static_cast<uint64_t>(1) << precision) * i / n);
    }
    out_cdf[n] = 1u << precision;
    return 0;
  }

  for (auto& v : cdf) {
    v = static_cast<uint32_t>(((1ull << precision) * v) / total);
  }
  // prefix sum
  for (size_t i = 1; i < cdf.size(); ++i) cdf[i] += cdf[i - 1];
  cdf.back() = 1u << precision;

  // Frequency stealing: every slot must have freq >= 1.
  for (int64_t i = 0; i < static_cast<int64_t>(cdf.size()) - 1; ++i) {
    if (cdf[i] == cdf[i + 1]) {
      uint32_t best_freq = ~0u;
      int64_t best_steal = -1;
      for (int64_t j = 0; j < static_cast<int64_t>(cdf.size()) - 1; ++j) {
        const uint32_t freq = cdf[j + 1] - cdf[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = j;
        }
      }
      if (best_steal < 0) return -2;
      if (best_steal < i) {
        for (int64_t j = best_steal + 1; j <= i; ++j) cdf[j]--;
      } else {
        for (int64_t j = i + 1; j <= best_steal; ++j) cdf[j]++;
      }
    }
  }

  std::memcpy(out_cdf, cdf.data(), cdf.size() * sizeof(uint32_t));
  return 0;
}

}  // extern "C"
