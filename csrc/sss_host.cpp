// Host-side native runtime: bit-packed column codec + scans.
//
// Counterpart of the reference's C++ kernel library
// (reference: src/simd_scan_compression.cpp:53-104 compress_9bit_input,
// src/simd_scan_decompression.cpp:6-55 decompress_unvectorized,
// src/simd_scan.cpp:20-100 scan_unvectorized,
// src/simd_scan_shared.cpp:9-23 shared_scan_128_sequential) — redesigned,
// not translated: the device runs the scan tiers; this library is the
// host runtime used for fast data ingest (packing columns at memory speed
// before device upload), host-side verification independent of JAX, and
// out-of-band tooling.  Generalized to widths 1..31 with explicit shift
// handling (no shift-count UB — SURVEY.md §5 "do not replicate").
//
// Layout contract (must stay byte-identical to shared_simd_scan_tpu.layout):
// value i occupies stream bits [i*width, (i+1)*width), LSB-first, stored
// little-endian.  Match bitvectors: bit i at stream bit i, LSB-first.
//
// Parallelized with OpenMP over 64-value-aligned chunks (every 64 values
// start and end on whole bytes only when width*64 % 8 == 0 — always true).

#include <cstdint>
#include <cstring>
#include <cstddef>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// pack: values[n] -> out bitstream (caller allocates >= (n*width+7)/8 + 8 B)
//
// 64-bit accumulator flushed in whole 32-bit units (a full 64-value chunk
// is exactly 8*width bytes = 2*width flushes, so chunks never overlap and
// no pre-zeroing pass is needed) — ~8x fewer stores than the byte-at-a-
// time form.
// ---------------------------------------------------------------------------
void sss_pack(const uint32_t* values, uint64_t n, int width, uint8_t* out) {
  const uint32_t mask = (width >= 32) ? 0xFFFFFFFFu : ((1u << width) - 1u);
  // chunk = 64 values: 64*width bits is a whole number of bytes (8*width).
  const uint64_t chunk = 64;
  const int64_t nchunks = (int64_t)((n + chunk - 1) / chunk);
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < nchunks; ++c) {
    const uint64_t lo = (uint64_t)c * chunk;
    const uint64_t hi = (lo + chunk < n) ? lo + chunk : n;
    uint64_t acc = 0;
    int acc_bits = 0;
    uint8_t* p = out + lo * width / 8;  // whole-byte boundary per chunk
    for (uint64_t i = lo; i < hi; ++i) {
      acc |= (uint64_t)(values[i] & mask) << acc_bits;
      acc_bits += width;
      if (acc_bits >= 32) {  // width <= 31 so one flush always suffices
        uint32_t w32 = (uint32_t)acc;
        std::memcpy(p, &w32, 4);
        p += 4;
        acc >>= 32;
        acc_bits -= 32;
      }
    }
    while (acc_bits > 0) {  // tail bits of the final (partial) chunk
      *p++ = (uint8_t)acc;
      acc >>= 8;
      acc_bits -= 8;
    }
  }
}

// ---------------------------------------------------------------------------
// unpack: bitstream -> values[n]
//
// AVX2 fast path (widths <= 25): per 8-value group the byte offset and
// bit shift of each value are fixed ((j*width)>>3, (j*width)&7), so the
// group is one 8-lane 32-bit gather + variable right shift + AND — the
// reference's own AVX2 formulation (decompress_256_avx2,
// src/simd_scan_decompression.cpp:427-470) applied to this layout, with
// the gather replacing its unaligned broadcast load.  Widths 26..31 can
// span 5 bytes after the shift and take the 64-bit-accumulator path with
// whole-uint32 refills.
// ---------------------------------------------------------------------------
void sss_unpack(const uint8_t* packed, uint64_t n, int width, uint32_t* out) {
  const uint32_t mask = (width >= 32) ? 0xFFFFFFFFu : ((1u << width) - 1u);
  const uint64_t nbytes = (n * (uint64_t)width + 7) / 8;
  const uint64_t chunk = 64;
  const int64_t nchunks = (int64_t)((n + chunk - 1) / chunk);
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < nchunks; ++c) {
    const uint64_t lo = (uint64_t)c * chunk;
    const uint64_t hi = (lo + chunk < n) ? lo + chunk : n;
    const uint8_t* p = packed + lo * width / 8;
#if defined(__AVX2__)
    // safe iff every gather stays inside the buffer: last group's last
    // lane reads 4 bytes at base + 7*width/8
    if (width <= 25 && hi - lo == 64 &&
        lo * width / 8 + 7 * (uint64_t)width + ((7 * width) >> 3) + 4 <= nbytes) {
      const __m256i voff = _mm256_setr_epi32(
          0, (1 * width) >> 3, (2 * width) >> 3, (3 * width) >> 3,
          (4 * width) >> 3, (5 * width) >> 3, (6 * width) >> 3,
          (7 * width) >> 3);
      const __m256i vsh = _mm256_setr_epi32(
          0, (1 * width) & 7, (2 * width) & 7, (3 * width) & 7,
          (4 * width) & 7, (5 * width) & 7, (6 * width) & 7, (7 * width) & 7);
      const __m256i vmask = _mm256_set1_epi32((int)mask);
      for (int g = 0; g < 8; ++g) {
        const uint8_t* base = p + (uint64_t)g * width;  // 8 values = width bytes
        __m256i x = _mm256_i32gather_epi32((const int*)base, voff, 1);
        x = _mm256_srlv_epi32(x, vsh);
        x = _mm256_and_si256(x, vmask);
        _mm256_storeu_si256((__m256i*)(out + lo + 8 * (uint64_t)g), x);
      }
      continue;
    }
#endif
    uint64_t acc = 0;
    int acc_bits = 0;
    const uint8_t* pend = packed + nbytes;
    for (uint64_t i = lo; i < hi; ++i) {
      if (acc_bits < width) {
        if (p + 4 <= pend) {  // whole-uint32 refill
          uint32_t x;
          std::memcpy(&x, p, 4);
          acc |= (uint64_t)x << acc_bits;
          p += 4;
          acc_bits += 32;
        } else {
          while (acc_bits < width && p < pend) {
            acc |= (uint64_t)(*p++) << acc_bits;
            acc_bits += 8;
          }
          acc_bits = acc_bits < width ? width : acc_bits;  // zero padding
        }
      }
      out[i] = (uint32_t)acc & mask;
      acc >>= width;
      acc_bits -= width;
    }
  }
}

// ---------------------------------------------------------------------------
// scan: one predicate -> LSB-first bitvector + hit count
// bits_out: caller allocates >= (n+7)/8 bytes, zeroed here.
// ---------------------------------------------------------------------------
uint64_t sss_scan(const uint8_t* packed, uint64_t n, int width, uint32_t key,
                  uint8_t* bits_out) {
  const uint32_t mask = (width >= 32) ? 0xFFFFFFFFu : ((1u << width) - 1u);
  const uint64_t nbytes = (n + 7) / 8;
  const uint64_t pbytes = (n * (uint64_t)width + 7) / 8;
  std::memset(bits_out, 0, nbytes);
  uint64_t hits = 0;
  const uint64_t chunk = 64;
  const int64_t nchunks = (int64_t)((n + chunk - 1) / chunk);
#pragma omp parallel for schedule(static) reduction(+ : hits)
  for (int64_t c = 0; c < nchunks; ++c) {
    const uint64_t lo = (uint64_t)c * chunk;
    const uint64_t hi = (lo + chunk < n) ? lo + chunk : n;
    const uint8_t* p = packed + lo * width / 8;
#if defined(__AVX2__)
    // AVX2 fast path: the unpack gather+srlv+AND (see sss_unpack) fused
    // with cmpeq+movemask — the reference's own scan structure (scan_256,
    // src/simd_scan.cpp:219-307) on this layout.  Same gather-safety
    // bound as sss_unpack.
    if (width <= 25 && hi - lo == 64 &&
        lo * width / 8 + 7 * (uint64_t)width + ((7 * width) >> 3) + 4 <=
            pbytes) {
      const __m256i voff = _mm256_setr_epi32(
          0, (1 * width) >> 3, (2 * width) >> 3, (3 * width) >> 3,
          (4 * width) >> 3, (5 * width) >> 3, (6 * width) >> 3,
          (7 * width) >> 3);
      const __m256i vsh = _mm256_setr_epi32(
          0, (1 * width) & 7, (2 * width) & 7, (3 * width) & 7,
          (4 * width) & 7, (5 * width) & 7, (6 * width) & 7, (7 * width) & 7);
      const __m256i vmask = _mm256_set1_epi32((int)mask);
      const __m256i vkey = _mm256_set1_epi32((int)key);
      uint64_t word = 0;
      for (int g = 0; g < 8; ++g) {
        const uint8_t* base = p + (uint64_t)g * width;
        __m256i x = _mm256_i32gather_epi32((const int*)base, voff, 1);
        x = _mm256_and_si256(_mm256_srlv_epi32(x, vsh), vmask);
        const __m256i eq = _mm256_cmpeq_epi32(x, vkey);
        const uint32_t m =
            (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(eq));
        word |= (uint64_t)m << (8 * g);  // lane j -> bit 8g+j, LSB-first
      }
      hits += (uint64_t)__builtin_popcountll(word);
      std::memcpy(bits_out + lo / 8, &word, 8);
      continue;
    }
#endif
    uint64_t acc = 0;
    int acc_bits = 0;
    uint64_t word = 0;  // chunk = 64 match bits
    for (uint64_t i = lo; i < hi; ++i) {
      while (acc_bits < width) {
        acc |= (uint64_t)(*p++) << acc_bits;
        acc_bits += 8;
      }
      const uint32_t v = (uint32_t)acc & mask;
      acc >>= width;
      acc_bits -= width;
      if (v == key) {
        word |= 1ull << (i - lo);
        ++hits;
      }
    }
    std::memcpy(bits_out + lo / 8, &word,
                (hi - lo + 7) / 8);  // little-endian: LSB-first stream order
  }
  return hits;
}

// ---------------------------------------------------------------------------
// shared scan: k predicates, one pass -> k bitvectors (stride (n+7)/8) and
// per-predicate hit counts.
// ---------------------------------------------------------------------------
void sss_shared_scan(const uint8_t* packed, uint64_t n, int width,
                     const uint32_t* keys, int k, uint8_t* bits_out,
                     uint64_t* counts_out) {
  const uint32_t mask = (width >= 32) ? 0xFFFFFFFFu : ((1u << width) - 1u);
  const uint64_t stride = (n + 7) / 8;
  std::memset(bits_out, 0, stride * (uint64_t)k);
  for (int j = 0; j < k; ++j) counts_out[j] = 0;
  const uint64_t chunk = 64;
  const int64_t nchunks = (int64_t)((n + chunk - 1) / chunk);
#pragma omp parallel
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
    const int nth = omp_get_num_threads();
#else
    const int tid = 0, nth = 1;
#endif
    const int kk = k < 64 ? k : 64;
    uint64_t local_counts[64] = {0};
    // contiguous chunk range per thread (better stream locality than
    // round-robin); counts accumulate thread-locally, one atomic per key
    const int64_t per = (nchunks + nth - 1) / nth;
    const int64_t c0 = (int64_t)tid * per;
    const int64_t c1 = (c0 + per < nchunks) ? c0 + per : nchunks;
#if defined(__AVX2__)
    const uint64_t pbytes = (n * (uint64_t)width + 7) / 8;
    const __m256i voff = _mm256_setr_epi32(
        0, (1 * width) >> 3, (2 * width) >> 3, (3 * width) >> 3,
        (4 * width) >> 3, (5 * width) >> 3, (6 * width) >> 3,
        (7 * width) >> 3);
    const __m256i vsh = _mm256_setr_epi32(
        0, (1 * width) & 7, (2 * width) & 7, (3 * width) & 7,
        (4 * width) & 7, (5 * width) & 7, (6 * width) & 7, (7 * width) & 7);
    const __m256i vmask = _mm256_set1_epi32((int)mask);
    __m256i vkeys[64];
    for (int j = 0; j < kk; ++j) vkeys[j] = _mm256_set1_epi32((int)keys[j]);
#endif
    for (int64_t c = c0; c < c1; ++c) {
      const uint64_t lo = (uint64_t)c * chunk;
      const uint64_t hi = (lo + chunk < n) ? lo + chunk : n;
      const uint8_t* p = packed + lo * width / 8;
      uint64_t words[64];  // k <= 64 supported in one pass per chunk
      for (int j = 0; j < kk; ++j) words[j] = 0;
#if defined(__AVX2__)
      // unpack each 8-value group ONCE (gather+srlv+AND), then
      // cmpeq+movemask per key — the reference's shared_scan_256_standard
      // structure (src/simd_scan_shared.cpp:295-330) on this layout
      if (width <= 25 && hi - lo == 64 &&
          lo * width / 8 + 7 * (uint64_t)width + ((7 * width) >> 3) + 4 <=
              pbytes) {
        for (int g = 0; g < 8; ++g) {
          const uint8_t* base = p + (uint64_t)g * width;
          __m256i x = _mm256_i32gather_epi32((const int*)base, voff, 1);
          x = _mm256_and_si256(_mm256_srlv_epi32(x, vsh), vmask);
          for (int j = 0; j < kk; ++j) {
            const __m256i eq = _mm256_cmpeq_epi32(x, vkeys[j]);
            const uint32_t m =
                (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(eq));
            words[j] |= (uint64_t)m << (8 * g);
          }
        }
        for (int j = 0; j < kk; ++j) {
          std::memcpy(bits_out + (uint64_t)j * stride + lo / 8, &words[j], 8);
          local_counts[j] += (uint64_t)__builtin_popcountll(words[j]);
        }
        continue;
      }
#endif
      uint64_t acc = 0;
      int acc_bits = 0;
      for (uint64_t i = lo; i < hi; ++i) {
        while (acc_bits < width) {
          acc |= (uint64_t)(*p++) << acc_bits;
          acc_bits += 8;
        }
        const uint32_t v = (uint32_t)acc & mask;
        acc >>= width;
        acc_bits -= width;
        for (int j = 0; j < kk; ++j)
          if (v == keys[j]) words[j] |= 1ull << (i - lo);
      }
      const uint64_t tail = (hi - lo + 7) / 8;
      for (int j = 0; j < kk; ++j) {
        std::memcpy(bits_out + (uint64_t)j * stride + lo / 8, &words[j], tail);
        local_counts[j] += (uint64_t)__builtin_popcountll(words[j]);
      }
    }
    for (int j = 0; j < kk; ++j) {
#pragma omp atomic
      counts_out[j] += local_counts[j];
    }
  }
  // k > 64: additional passes
  if (k > 64)
    sss_shared_scan(packed, n, width, keys + 64, k - 64, bits_out + 64 * stride,
                    counts_out + 64);
}

// ---------------------------------------------------------------------------
// interleave: k bitvectors (stride bytes apart, LSB-first byte streams) ->
// linear layout out[g*k + j] = byte g of bitvector j (the reference's
// shared_scan_128_linear byte order, simd_scan_shared_linear.cpp:57).
//
// Host-side companion of the device byte interleave
// (shared_simd_scan_tpu/ops/scan.py interleave_linear): callers exporting
// match bytes to host memory fetch the native (k, W) layout and interleave
// here at memcpy-class speed.  AVX2 fast path for k % 8 == 0: 32 groups per
// iteration via the 3-stage unpack byte transpose (8 streams -> 8-byte
// units), one 8-byte store per (group, key-octet).
//
// KEY-TILED loop order (octet outer, groups inner): the first version
// walked all k strided streams per 32-group unit and degraded 3x in
// per-byte cost at k=64 (64 same-set streams thrash L1's associativity
// — the streams are stride bytes apart, typically page-aligned-ish).
// One octet pass keeps only 8 input streams hot; the chunk is sized so
// the output region the k/8 passes revisit stays cache-resident.
// ---------------------------------------------------------------------------
void sss_interleave(const uint8_t* bits, uint64_t stride, int k,
                    uint64_t nbytes, uint8_t* out) {
  // groups per task: output region chunk*k bytes sized from a measured
  // sweep (8/16/64/128/256/512 KB probed at k=64/128, 512 MiB stride):
  // 16 KB best for k <= 64 (264 ms at k=64 vs 318 at 64 KB); k = 128
  // prefers 128 KB (688-763 ms vs 886-947 at 16 KB — the tiny
  // per-stream spans never ramp the prefetcher).  k <= 8 keeps the
  // original 4096 groups (single pass, no revisit).
  const uint64_t target_bytes = (k <= 64) ? 16384u : 131072u;
  uint64_t chunk = (k <= 8) ? 4096 : target_bytes / (uint64_t)k / 32 * 32;
  if (chunk < 32) chunk = 32;
  const int64_t nchunks = (int64_t)((nbytes + chunk - 1) / chunk);
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < nchunks; ++c) {
    const uint64_t lo = (uint64_t)c * chunk;
    const uint64_t hi = (lo + chunk < nbytes) ? lo + chunk : nbytes;
    uint64_t g = lo;
#if defined(__AVX2__)
    if (k % 8 == 0) {
      const uint64_t vend = lo + (hi - lo) / 32 * 32;
      for (int q = 0; q + 8 <= k; q += 8) {
        for (g = lo; g + 32 <= vend; g += 32) {
          const uint8_t* s = bits + (uint64_t)q * stride + g;
          const __m256i r0 = _mm256_loadu_si256((const __m256i*)(s + 0 * stride));
          const __m256i r1 = _mm256_loadu_si256((const __m256i*)(s + 1 * stride));
          const __m256i r2 = _mm256_loadu_si256((const __m256i*)(s + 2 * stride));
          const __m256i r3 = _mm256_loadu_si256((const __m256i*)(s + 3 * stride));
          const __m256i r4 = _mm256_loadu_si256((const __m256i*)(s + 4 * stride));
          const __m256i r5 = _mm256_loadu_si256((const __m256i*)(s + 5 * stride));
          const __m256i r6 = _mm256_loadu_si256((const __m256i*)(s + 6 * stride));
          const __m256i r7 = _mm256_loadu_si256((const __m256i*)(s + 7 * stride));
          const __m256i t0 = _mm256_unpacklo_epi8(r0, r1);
          const __m256i t1 = _mm256_unpackhi_epi8(r0, r1);
          const __m256i t2 = _mm256_unpacklo_epi8(r2, r3);
          const __m256i t3 = _mm256_unpackhi_epi8(r2, r3);
          const __m256i t4 = _mm256_unpacklo_epi8(r4, r5);
          const __m256i t5 = _mm256_unpackhi_epi8(r4, r5);
          const __m256i t6 = _mm256_unpacklo_epi8(r6, r7);
          const __m256i t7 = _mm256_unpackhi_epi8(r6, r7);
          const __m256i u0 = _mm256_unpacklo_epi16(t0, t2);
          const __m256i u1 = _mm256_unpackhi_epi16(t0, t2);
          const __m256i u2 = _mm256_unpacklo_epi16(t1, t3);
          const __m256i u3 = _mm256_unpackhi_epi16(t1, t3);
          const __m256i u4 = _mm256_unpacklo_epi16(t4, t6);
          const __m256i u5 = _mm256_unpackhi_epi16(t4, t6);
          const __m256i u6 = _mm256_unpacklo_epi16(t5, t7);
          const __m256i u7 = _mm256_unpackhi_epi16(t5, t7);
          // v_i: lane0 = groups {2i, 2i+1}, lane1 = groups {2i+16, 2i+17},
          // each an 8-byte unit of keys q..q+7
          const __m256i v[8] = {
              _mm256_unpacklo_epi32(u0, u4), _mm256_unpackhi_epi32(u0, u4),
              _mm256_unpacklo_epi32(u1, u5), _mm256_unpackhi_epi32(u1, u5),
              _mm256_unpacklo_epi32(u2, u6), _mm256_unpackhi_epi32(u2, u6),
              _mm256_unpacklo_epi32(u3, u7), _mm256_unpackhi_epi32(u3, u7)};
          uint8_t* o = out + g * (uint64_t)k + q;
          if (k == 8) {
            // units are contiguous: two 16-byte stores per vector
            for (int i = 0; i < 8; ++i) {
              _mm_storeu_si128((__m128i*)(o + (uint64_t)(2 * i) * 8),
                               _mm256_castsi256_si128(v[i]));
              _mm_storeu_si128((__m128i*)(o + (uint64_t)(2 * i + 16) * 8),
                               _mm256_extracti128_si256(v[i], 1));
            }
          } else {
            for (int i = 0; i < 8; ++i) {
              alignas(32) uint64_t lanes[4];
              _mm256_store_si256((__m256i*)lanes, v[i]);
              std::memcpy(o + (uint64_t)(2 * i) * k, &lanes[0], 8);
              std::memcpy(o + (uint64_t)(2 * i + 1) * k, &lanes[1], 8);
              std::memcpy(o + (uint64_t)(2 * i + 16) * k, &lanes[2], 8);
              std::memcpy(o + (uint64_t)(2 * i + 17) * k, &lanes[3], 8);
            }
          }
        }
      }
    } else if (k % 4 == 0) {
      // quad passes (k = 4m, m odd — e.g. k=20 ran the scalar loop at
      // ~11 GB/s): 2-stage unpack byte transpose of 4 streams -> 4-byte
      // units, one 4-byte store per (group, key-quad)
      const uint64_t vend = lo + (hi - lo) / 32 * 32;
      for (int q = 0; q + 4 <= k; q += 4) {
        for (g = lo; g + 32 <= vend; g += 32) {
          const uint8_t* s = bits + (uint64_t)q * stride + g;
          const __m256i r0 = _mm256_loadu_si256((const __m256i*)(s + 0 * stride));
          const __m256i r1 = _mm256_loadu_si256((const __m256i*)(s + 1 * stride));
          const __m256i r2 = _mm256_loadu_si256((const __m256i*)(s + 2 * stride));
          const __m256i r3 = _mm256_loadu_si256((const __m256i*)(s + 3 * stride));
          const __m256i t0 = _mm256_unpacklo_epi8(r0, r1);
          const __m256i t1 = _mm256_unpackhi_epi8(r0, r1);
          const __m256i t2 = _mm256_unpacklo_epi8(r2, r3);
          const __m256i t3 = _mm256_unpackhi_epi8(r2, r3);
          // u[i]: lane0 = groups 4i..4i+3, lane1 = groups 16+4i..16+4i+3,
          // each a 4-byte unit of keys q..q+3
          const __m256i u[4] = {
              _mm256_unpacklo_epi16(t0, t2), _mm256_unpackhi_epi16(t0, t2),
              _mm256_unpacklo_epi16(t1, t3), _mm256_unpackhi_epi16(t1, t3)};
          uint8_t* o = out + g * (uint64_t)k + q;
          for (int i = 0; i < 4; ++i) {
            alignas(32) uint32_t lanes[8];
            _mm256_store_si256((__m256i*)lanes, u[i]);
            for (int j = 0; j < 4; ++j) {
              std::memcpy(o + (uint64_t)(4 * i + j) * k, &lanes[j], 4);
              std::memcpy(o + (uint64_t)(4 * i + j + 16) * k, &lanes[4 + j], 4);
            }
          }
        }
      }
    }
#endif
    for (; g < hi; ++g)
      for (int j = 0; j < k; ++j)
        out[g * (uint64_t)k + j] = bits[(uint64_t)j * stride + g];
  }
}

int sss_version(void) { return 2; }

}  // extern "C"
