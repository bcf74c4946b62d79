// Native host entropy stage: the serial, branchy bit-level inner loops that
// feed the device DSP.  C ABI (consumed via ctypes, no pybind dependency).
//
// Components:
//  * MP3 Layer III Huffman big-values/count1 decode (the reference's hot
//    loop, minimp3.d:748-883) -> quantized ints + per-coefficient gains
//  * FLAC subframe + partitioned-Rice residual decode (drflac.d:1149-1330)
//    -> dense residual/coefficient tensors
//
// Tables are injected from Python at init (canonical spec data from
// audio_formats_tpu/utils/tables) so no constant data is duplicated here.
//
// Build: g++ -O3 -shared -fPIC (see ../native.py).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// Bit reader (MSB-first) with a 64-bit cache
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* buf;
  int64_t nbits;
  int64_t pos;
};

static inline uint32_t br_peek(const BitReader* br, int n) {
  // n <= 32; reads beyond the end return zero bits (callers bound reads)
  int64_t p = br->pos;
  int64_t byte = p >> 3;
  uint64_t w;
  int64_t size = (br->nbits + 7) >> 3;
  if (byte + 8 <= size) {
    // hot path: one unaligned 64-bit load + byteswap
    memcpy(&w, br->buf + byte, 8);
    w = __builtin_bswap64(w);
  } else {
    // EOF tail: assemble byte-wise, zero-padded
    w = 0;
    for (int i = 0; i < 8; i++) {
      w = (w << 8) | (byte + i < size ? (uint64_t)br->buf[byte + i] : 0);
    }
  }
  return (uint32_t)((w << (p & 7)) >> (64 - n));
}

static inline uint32_t br_get(BitReader* br, int n) {
  uint32_t v = n ? br_peek(br, n) : 0;
  br->pos += n;
  return v;
}

static inline int br_unary(BitReader* br) {
  // count zeros to the first 1 bit; returns count, consumes count+1 bits
  int count = 0;
  for (;;) {
    if (br->pos >= br->nbits) return -1;
    int64_t byte = br->pos >> 3;
    int64_t size = (br->nbits + 7) >> 3;
    if (byte + 8 <= size) {
      // hot path: scan up to 56+ bits at once with clz
      uint64_t w;
      memcpy(&w, br->buf + byte, 8);
      w = __builtin_bswap64(w) << (br->pos & 7);
      if (w) {
        int lead = __builtin_clzll(w);
        int avail = 64 - (int)(br->pos & 7);
        if (lead < avail) {
          br->pos += lead + 1;
          return count + lead;
        }
        count += avail;
        br->pos += avail;
      } else {
        int avail = 64 - (int)(br->pos & 7);
        count += avail;
        br->pos += avail;
      }
      continue;
    }
    int rem = 8 - (int)(br->pos & 7);
    uint8_t chunk = br->buf[byte] & ((1 << rem) - 1);
    if (chunk == 0) {
      count += rem;
      br->pos += rem;
    } else {
      int lead = rem - (32 - __builtin_clz((uint32_t)chunk) );
      count += lead;
      br->pos += lead + 1;
      return count;
    }
  }
}

// ---------------------------------------------------------------------------
// MP3 Huffman
// ---------------------------------------------------------------------------

// Flat per-table LUTs sized 1<<maxlen; entry packs (len<<16 | x<<8 | y).
static uint32_t* g_mp3_lut[34] = {nullptr};
static int g_mp3_lut_bits[34] = {0};
static int g_mp3_linbits[32] = {0};

// codes: int32 quads (code, len, x, y) * n
int af_mp3_set_table(int table_id, const int32_t* codes, int n, int linbits) {
  if (table_id < 0 || table_id >= 34) return -1;
  int maxlen = 0;
  for (int i = 0; i < n; i++) maxlen = codes[i * 4 + 1] > maxlen ? codes[i * 4 + 1] : maxlen;
  if (maxlen == 0) {  // empty table (table 0)
    g_mp3_lut[table_id] = nullptr;
    g_mp3_lut_bits[table_id] = 0;
    if (table_id < 32) g_mp3_linbits[table_id] = linbits;
    return 0;
  }
  size_t size = (size_t)1 << maxlen;
  uint32_t* lut = (uint32_t*)malloc(size * sizeof(uint32_t));
  if (!lut) return -1;
  free(g_mp3_lut[table_id]);  // re-registration must not leak the old LUT
  memset(lut, 0xFF, size * sizeof(uint32_t));
  for (int i = 0; i < n; i++) {
    uint32_t code = (uint32_t)codes[i * 4 + 0];
    int len = codes[i * 4 + 1];
    uint32_t x = (uint32_t)codes[i * 4 + 2];
    uint32_t y = (uint32_t)codes[i * 4 + 3];
    uint32_t base = code << (maxlen - len);
    uint32_t fill = 1u << (maxlen - len);
    uint32_t entry = ((uint32_t)len << 16) | (x << 8) | y;
    for (uint32_t j = 0; j < fill; j++) lut[base + j] = entry;
  }
  g_mp3_lut[table_id] = lut;
  g_mp3_lut_bits[table_id] = maxlen;
  if (table_id < 32) g_mp3_linbits[table_id] = linbits;
  return 0;
}

// Decode one granule-channel.  Layout of scalar args mirrors the Python
// implementation (models/mp3.py _huffman).  Returns the final bit position
// (== limit_bits), or -1 on invalid codes.
int64_t af_mp3_huffman(
    const uint8_t* maindata, int64_t nbytes, int64_t start_bits,
    int64_t limit_bits,
    const int32_t* table_select,   // [3]
    const int32_t* region_count,   // [3]
    const uint8_t* sfbtab,         // [40+] width entries, 0-terminated
    const float* scf,              // [40] per-sfb gains
    int32_t big_values, int32_t count1_table,
    int32_t* q_out, float* gain_out /* [576] each */) {
  BitReader br = {maindata, nbytes * 8, start_bits};
  for (int i = 0; i < 576; i++) { q_out[i] = 0; gain_out[i] = 0.0f; }

  int pos = 0, sfb_i = 0, scf_i = 0;
  float one = 0.0f;
  int big = big_values;

  for (int region = 0; region < 3 && big > 0; region++) {
    int tab = table_select[region];
    uint32_t* lut = g_mp3_lut[tab];
    int lut_bits = g_mp3_lut_bits[tab];
    int linbits = g_mp3_linbits[tab];
    int sfb_cnt = region_count[region];
    for (;;) {
      int np_pairs = sfbtab[sfb_i] / 2;
      sfb_i++;
      int pairs = big < np_pairs ? big : np_pairs;
      one = scf[scf_i];
      scf_i++;
      for (int p2 = 0; p2 < pairs; p2++) {
        int x = 0, y = 0;
        if (lut) {
          uint32_t peek = br_peek(&br, lut_bits <= 24 ? lut_bits : lut_bits);
          uint32_t e = lut[peek];
          if (e == 0xFFFFFFFFu) return -1;
          br.pos += (int)(e >> 16);
          x = (int)((e >> 8) & 0xFF);
          y = (int)(e & 0xFF);
        }
        int vals[2] = {x, y};
        for (int j = 0; j < 2; j++) {
          int v = vals[j];
          if (v == 15 && linbits) v += (int)br_get(&br, linbits);
          if (v && br_get(&br, 1)) v = -v;
          if (pos < 576) { q_out[pos] = v; gain_out[pos] = one; }
          pos++;
        }
      }
      big -= np_pairs;
      sfb_cnt -= 1;
      if (big <= 0 || sfb_cnt < 0) break;
    }
  }

  // count1 region
  {
    uint32_t* lut = g_mp3_lut[32 + count1_table];
    int lut_bits = g_mp3_lut_bits[32 + count1_table];
    int npairs = 1 - big;
    while (pos <= 572) {
      uint32_t peek = br_peek(&br, lut_bits);
      uint32_t e = lut[peek];
      if (e == 0xFFFFFFFFu) return -1;
      br.pos += (int)(e >> 16);
      if (br.pos > limit_bits) break;
      uint32_t v = (e >> 8) & 0xFF;  // count1 mask lives in the x slot
      int stop = 0;
      for (int s = 0; s < 4; s++) {
        if ((s & 1) == 0) {
          if (--npairs == 0) {
            int np_pairs = sfbtab[sfb_i] / 2;
            sfb_i++;
            if (np_pairs == 0) { stop = 1; break; }
            npairs = np_pairs;
            one = scf[scf_i];
            scf_i++;
          }
        }
        if ((v >> (3 - s)) & 1) {
          int val = br_get(&br, 1) ? -1 : 1;
          q_out[pos + s] = val;
          gain_out[pos + s] = one;
        } else {
          gain_out[pos + s] = one;
        }
      }
      if (stop) break;
      pos += 4;
    }
  }
  return limit_bits;
}

// ---------------------------------------------------------------------------
// FLAC frame parse (subframes + Rice residuals)
// ---------------------------------------------------------------------------

// Fixed predictor coefficients
static const int32_t kFixedCoef[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

static inline int32_t br_signed(BitReader* br, int n) {
  if (n == 0) return 0;
  uint32_t v = br_get(br, n);
  if (v >= (1u << (n - 1))) return (int32_t)v - (int32_t)(1u << n);
  return (int32_t)v;
}

// Parses one FLAC frame starting at bit position `start_bits` in `data`.
// Outputs (caller-allocated):
//   residual  [max_ch * max_block] int32 (row-major per channel)
//   coeffs    [max_ch * 32] int32
//   order, shift, wasted, bps  [max_ch] int32
//   meta[0]=blocksize meta[1]=chan_assignment meta[2]=nch meta[3]=end_bitpos lo
//   meta[4]=end_bitpos hi
// Returns 0 on success, negative error code otherwise.
// ---- fixed-width residual packing (device-upload diet) --------------------
// The Rice-decoded residuals upload at 32 bits/sample; almost all fit far
// fewer.  The host packs each lane at the window's uniform width w (so the
// device unpack is static-shape shift arithmetic, no gathers): sample i
// occupies bits [i*w, i*w+w) big-endian.  Positions < zero_until pack as 0
// (they ride the int32 warm-up side channel instead).

// Per-lane signed bit-widths: value v fits w bits iff (v<0 ? ~v : v) < 2^(w-1)
int af_flac_widths(const int32_t* res, int32_t L, int32_t n,
                   const int32_t* orders, int32_t* w_out) {
  int wmax = 1;
  for (int l = 0; l < L; l++) {
    const int32_t* r = res + (int64_t)l * n;
    int zu = orders[l] < 32 ? orders[l] : 32;
    uint32_t mx = 0;
    for (int i = zu; i < n; i++) {
      int32_t v = r[i];
      uint32_t m = v < 0 ? ~(uint32_t)v : (uint32_t)v;
      if (m > mx) mx = m;
    }
    int w = 1;
    while (mx) { mx >>= 1; w++; }
    w_out[l] = w;
    if (w > wmax) wmax = w;
  }
  return wmax;
}

// Pack every lane at width w into rows of ceil(n*w/32) uint32 words.
int af_flac_pack(const int32_t* res, int32_t L, int32_t n,
                 const int32_t* orders, int32_t w,
                 uint32_t* out, int32_t out_stride_words) {
  uint32_t mask = (w < 32) ? ((1u << w) - 1u) : 0xFFFFFFFFu;
  for (int l = 0; l < L; l++) {
    const int32_t* r = res + (int64_t)l * n;
    uint32_t* o = out + (int64_t)l * out_stride_words;
    int zu = orders[l] < 32 ? orders[l] : 32;
    uint64_t acc = 0;
    int nb = 0, ow = 0;
    for (int i = 0; i < n; i++) {
      uint32_t v = (i < zu) ? 0u : ((uint32_t)r[i] & mask);
      acc = (acc << w) | v;
      nb += w;
      if (nb >= 32) {
        o[ow++] = (uint32_t)(acc >> (nb - 32));
        nb -= 32;
      }
    }
    if (nb) o[ow++] = (uint32_t)(acc << (32 - nb));
    if (ow < out_stride_words) o[ow] = 0;
  }
  return 0;
}

// ---- gather variants: pack straight from the window parser's batch rows ---
// The batch scheduler used to scatter every parsed residual row into a
// padded [S*nch, max_bs] array before af_flac_widths/af_flac_pack re-read
// it — one full extra pass over ~GB/rep of int32 residuals.  These
// variants take per-row POINTERS (addresses into af_flac_parse_window[_multi]
// output buffers) plus a per-row valid length ns[l]; samples at i >= ns[l]
// read as 0 (exactly what the zero-initialized scatter produced).  A null
// row pointer is an all-zero padding row.

int af_flac_widths_gather(const int64_t* rows, int32_t L, int32_t n,
                          const int32_t* ns, const int32_t* orders,
                          int32_t* w_out) {
  int wmax = 1;
  for (int l = 0; l < L; l++) {
    const int32_t* r = (const int32_t*)(intptr_t)rows[l];
    int lim = ns[l] < n ? ns[l] : n;
    int zu = orders[l] < 32 ? orders[l] : 32;
    uint32_t mx = 0;
    if (r)
      for (int i = zu; i < lim; i++) {
        int32_t v = r[i];
        uint32_t m = v < 0 ? ~(uint32_t)v : (uint32_t)v;
        if (m > mx) mx = m;
      }
    int w = 1;
    while (mx) { mx >>= 1; w++; }
    w_out[l] = w;
    if (w > wmax) wmax = w;
  }
  return wmax;
}

// Pack rows at width w; also emits the int32 warm-up side channel
// (warm[l][0:32] = row[0:min(32, ns[l])], zero beyond) when warm != NULL.
int af_flac_pack_gather(const int64_t* rows, int32_t L, int32_t n,
                        const int32_t* ns, const int32_t* orders, int32_t w,
                        uint32_t* out, int32_t out_stride_words,
                        int32_t* warm) {
  uint32_t mask = (w < 32) ? ((1u << w) - 1u) : 0xFFFFFFFFu;
  for (int l = 0; l < L; l++) {
    const int32_t* r = (const int32_t*)(intptr_t)rows[l];
    uint32_t* o = out + (int64_t)l * out_stride_words;
    int lim = r ? (ns[l] < n ? ns[l] : n) : 0;
    int zu = orders[l] < 32 ? orders[l] : 32;
    uint64_t acc = 0;
    int nb = 0, ow = 0;
    for (int i = 0; i < lim; i++) {
      uint32_t v = (i < zu) ? 0u : ((uint32_t)r[i] & mask);
      acc = (acc << w) | v;
      nb += w;
      if (nb >= 32) {
        o[ow++] = (uint32_t)(acc >> (nb - 32));
        nb -= 32;
      }
    }
    // samples [lim, n) are zeros: flush the accumulator, zero the rest
    if (nb) o[ow++] = (uint32_t)(acc << (32 - nb));
    for (; ow < out_stride_words; ow++) o[ow] = 0;
    if (warm) {
      int32_t* wr = warm + (int64_t)l * 32;
      int wl = lim < 32 ? lim : 32;
      for (int i = 0; i < wl; i++) wr[i] = r[i];
      for (int i = wl; i < 32; i++) wr[i] = 0;
    }
  }
  return 0;
}

// Concatenate each row's first ns[l] uint32 words (the MP3 pooled
// bit-plane build: per-lane spans at their true sizes, one pass, no
// boolean-mask temp).  Returns words written.
int64_t af_u32_pack_prefix_rows(const uint32_t* rows, int32_t L,
                                int32_t stride, const int32_t* ns,
                                uint32_t* out) {
  int64_t o = 0;
  for (int l = 0; l < L; l++) {
    int n = ns[l];
    if (n > stride) n = stride;
    if (n > 0) {
      memcpy(out + o, rows + (int64_t)l * stride, (size_t)n * 4);
      o += n;
    }
  }
  return o;
}

// ---- byte-level frame sync index (device-Rice mode) -----------------------
// Finds frame start offsets WITHOUT walking the Rice residuals: candidate
// positions must pass the 2-byte sync check, full header field validation,
// the header CRC-8, and — decisively — carry the exactly-expected frame or
// sample number (UTF-8 field), which no false sync can fake.  The device
// FSM (ops/flac_rice.py) then decodes each frame as an independent lane;
// its end positions chain-check against this index downstream.
static uint8_t g_crc8[256];
static int g_crc8_ready = 0;

static void crc8_build(void) {
  for (int i = 0; i < 256; i++) {
    uint8_t c = (uint8_t)i;
    for (int j = 0; j < 8; j++)
      c = (uint8_t)((c & 0x80) ? (c << 1) ^ 0x07 : (c << 1));
    g_crc8[i] = c;
  }
  g_crc8_ready = 1;
}

// Parses + validates one frame header at byte `off`.  Returns header size
// in BYTES (>0) on success and fills out fields; 0 on mismatch.
static int flac_header_at(const uint8_t* d, int64_t off, int64_t nbytes,
                          int streaminfo_bps, int expect_ch,
                          int max_block, int64_t expect_num,
                          int* bs_out, int* ca_out, int* bps_out,
                          int64_t* num_out, int* fixed_bs_out) {
  if (off + 6 > nbytes) return 0;
  const uint8_t* h = d + off;
  if (h[0] != 0xFF || (h[1] & 0xFC) != 0xF8) return 0;
  int fixed_bs = !(h[1] & 1);
  int bs_code = h[2] >> 4;
  int sr_code = h[2] & 15;
  int ca = h[3] >> 4;
  int bps_code = (h[3] >> 1) & 7;
  if (h[3] & 1) return 0;
  if (bs_code == 0 || sr_code == 15 || ca > 10) return 0;
  static const int bps_table[8] = {0, 8, 12, -1, 16, 20, 24, -1};
  int bps = bps_table[bps_code];
  if (bps == -1) return 0;
  if (bps == 0) bps = streaminfo_bps;
  int nch = ca <= 7 ? ca + 1 : 2;
  if (nch != expect_ch) return 0;
  int p = 4;
  // UTF-8 number
  int64_t num = 0;
  {
    uint32_t first = h[p++];
    if (first < 0x80) num = first;
    else {
      int n = 0;
      uint32_t mask = 0x40;
      while (first & mask) { n++; mask >>= 1; }
      if (n == 0 || n > 6) return 0;
      num = first & (mask - 1);
      if (off + p + n + 1 > nbytes) return 0;
      for (int i = 0; i < n; i++) {
        uint32_t cc = h[p++];
        if ((cc & 0xC0) != 0x80) return 0;
        num = (num << 6) | (cc & 0x3F);
      }
    }
  }
  int blocksize;
  if (bs_code == 1) blocksize = 192;
  else if (bs_code >= 2 && bs_code <= 5) blocksize = 576 << (bs_code - 2);
  else if (bs_code == 6) {
    if (off + p + 1 > nbytes) return 0;
    blocksize = h[p++] + 1;
  } else if (bs_code == 7) {
    if (off + p + 2 > nbytes) return 0;
    blocksize = ((h[p] << 8) | h[p + 1]) + 1;
    p += 2;
  } else blocksize = 256 << (bs_code - 8);
  if (blocksize > max_block) return 0;
  if (sr_code == 12) p += 1;
  else if (sr_code == 13 || sr_code == 14) p += 2;
  if (off + p + 1 > nbytes) return 0;
  if (!g_crc8_ready) crc8_build();
  uint8_t crc = 0;
  for (int i = 0; i < p; i++) crc = g_crc8[crc ^ h[i]];
  if (crc != h[p]) return 0;
  p += 1;
  if (expect_num >= 0 && num != expect_num) return 0;
  *bs_out = blocksize;
  *ca_out = ca;
  *bps_out = bps;
  *num_out = num;
  *fixed_bs_out = fixed_bs;
  return p;
}

// Scan up to max_frames frame headers from byte `off`.  state[0] = next
// expected number (frame # or first sample #; -1 = accept any, then
// lock), state[1] = 1 once variable-blocksize (sample numbering) is
// known.  Per frame: offs (byte), data_bits (absolute bit of subframe
// 0), bs, ca, bps.  Returns frames found; state[2] = next search byte.
int af_flac_sync_index(
    const uint8_t* data, int64_t nbytes, int64_t off,
    int32_t streaminfo_bps, int32_t expect_ch, int32_t max_block,
    int32_t max_frames, int64_t* state,
    int64_t* offs, int64_t* data_bits, int32_t* bs_arr, int32_t* ca_arr,
    int32_t* bps_arr) {
  int64_t expect = state[0];
  int n = 0;
  // margin 6 = the minimum validated header (sync2 + meta2 + num1 +
  // crc1, flac_header_at bounds-checks the rest): a tiny final
  // constant frame can start within 16 bytes of EOF and must still
  // index (truncated bodies are caught downstream by the frame
  // chain / err lattice)
  while (n < max_frames && off + 6 <= nbytes) {
    int bs, ca, bps, fixed_bs;
    int64_t num;
    int hl = flac_header_at(data, off, nbytes, streaminfo_bps, expect_ch,
                            max_block, expect, &bs, &ca, &bps, &num,
                            &fixed_bs);
    if (hl <= 0) {
      // resync: search forward for the next candidate
      int64_t q = off + 1;
      int found = 0;
      while (q + 6 <= nbytes) {
        if (data[q] == 0xFF && (data[q + 1] & 0xFC) == 0xF8) {
          hl = flac_header_at(data, q, nbytes, streaminfo_bps, expect_ch,
                              max_block, expect, &bs, &ca, &bps, &num,
                              &fixed_bs);
          if (hl > 0) { off = q; found = 1; break; }
        }
        q++;
      }
      if (!found) break;
    }
    offs[n] = off;
    data_bits[n] = off * 8 + (int64_t)hl * 8;
    bs_arr[n] = bs;
    ca_arr[n] = ca;
    bps_arr[n] = bps;
    n++;
    expect = fixed_bs ? num + 1 : num + bs;
    if (!fixed_bs) state[1] = 1;  // latch: once variable-blocksize numbering
                                  // is seen, it stays known
    // jump past the minimum possible frame body (subframe headers +
    // constant subframes can be tiny; be conservative)
    off += hl + 2;
    // search for the next header from here
    while (off + 6 <= nbytes &&
           !(data[off] == 0xFF && (data[off + 1] & 0xFC) == 0xF8 &&
             flac_header_at(data, off, nbytes, streaminfo_bps, expect_ch,
                            max_block, expect, &bs, &ca, &bps, &num,
                            &fixed_bs) > 0))
      off++;
  }
  state[0] = expect;
  state[2] = off;
  return n;
}

int af_flac_parse_frame(
    const uint8_t* data, int64_t nbytes, int64_t start_bits,
    int32_t streaminfo_bps, int32_t expect_channels,
    int32_t max_block,
    int32_t* residual, int32_t* coeffs, int32_t* order_out,
    int32_t* shift_out, int32_t* wasted_out, int32_t* bps_out,
    int64_t* meta) {
  BitReader br = {data, nbytes * 8, start_bits};
  if (br_get(&br, 14) != 0x3FFE) return -1;
  br_get(&br, 1);
  br_get(&br, 1);
  int bs_code = (int)br_get(&br, 4);
  int sr_code = (int)br_get(&br, 4);
  int chan_assignment = (int)br_get(&br, 4);
  int bps_code = (int)br_get(&br, 3);
  br_get(&br, 1);
  // UTF-8 coded number
  {
    uint32_t first = br_get(&br, 8);
    if (first >= 0x80) {
      int n = 0;
      uint32_t mask = 0x40;
      while (first & mask) { n++; mask >>= 1; }
      if (n == 0 || n > 6) return -2;
      for (int i = 0; i < n; i++) {
        uint32_t c = br_get(&br, 8);
        if ((c & 0xC0) != 0x80) return -2;
      }
    }
  }
  int blocksize;
  if (bs_code == 1) blocksize = 192;
  else if (bs_code >= 2 && bs_code <= 5) blocksize = 576 << (bs_code - 2);
  else if (bs_code == 6) blocksize = (int)br_get(&br, 8) + 1;
  else if (bs_code == 7) blocksize = (int)br_get(&br, 16) + 1;
  else if (bs_code >= 8) blocksize = 256 << (bs_code - 8);
  else return -3;
  if (blocksize > max_block) return -3;
  if (sr_code == 12) br_get(&br, 8);
  else if (sr_code == 13 || sr_code == 14) br_get(&br, 16);
  else if (sr_code == 15) return -4;
  static const int bps_table[8] = {0, 8, 12, -1, 16, 20, 24, -1};
  int bps = bps_table[bps_code];
  if (bps == -1) return -5;
  if (bps == 0) bps = streaminfo_bps;
  br_get(&br, 8);  // CRC-8 (stored, not validated — as drflac)

  int nch = chan_assignment <= 7 ? chan_assignment + 1 : 2;
  if (chan_assignment > 10) return -6;
  if (nch != expect_channels) return -6;

  for (int ci = 0; ci < nch; ci++) {
    int sub_bps = bps;
    if ((chan_assignment == 8 || chan_assignment == 10) && ci == 1) sub_bps++;
    else if (chan_assignment == 9 && ci == 0) sub_bps++;

    uint32_t header = br_get(&br, 8);
    if (header & 0x80) return -7;
    int t = (header & 0x7E) >> 1;
    int wasted = 0;
    if (header & 1) {
      int u = br_unary(&br);
      if (u < 0) return -8;
      wasted = u + 1;
    }
    if (wasted >= sub_bps) return -8;  // corrupt: effective width <= 0
    sub_bps -= wasted;
    int32_t* res = residual + (int64_t)ci * max_block;
    int32_t* cf = coeffs + ci * 32;
    for (int j = 0; j < 32; j++) cf[j] = 0;
    int order = 0, shift = 0;

    if (t == 0) {  // CONSTANT
      int32_t v = br_signed(&br, sub_bps);
      for (int i = 0; i < blocksize; i++) res[i] = v;
      order = blocksize;
    } else if (t == 1) {  // VERBATIM
      for (int i = 0; i < blocksize; i++) res[i] = br_signed(&br, sub_bps);
      order = blocksize;
    } else if (t & 0x20) {  // LPC
      order = (t & 0x1F) + 1;
      for (int i = 0; i < order; i++) res[i] = br_signed(&br, sub_bps);
      int precision = (int)br_get(&br, 4);
      if (precision == 15) return -9;
      precision += 1;
      shift = br_signed(&br, 5);
      if (shift < 0) shift = 0;
      for (int j = 0; j < order; j++) cf[j] = br_signed(&br, precision);
      // residual
      goto residual_decode;
    } else if (t & 0x08) {  // FIXED
      order = t & 0x07;
      if (order > 4) return -10;
      for (int i = 0; i < order; i++) res[i] = br_signed(&br, sub_bps);
      for (int j = 0; j < 4; j++) cf[j] = kFixedCoef[order][j];
      goto residual_decode;
    } else {
      return -11;
    }
    goto done_subframe;

  residual_decode: {
      int method = (int)br_get(&br, 2);
      if (method > 1) return -12;
      int param_bits = method == 0 ? 4 : 5;
      int escape = method == 0 ? 15 : 31;
      int partition_order = (int)br_get(&br, 4);
      int idx = order;
      int n_partitions = 1 << partition_order;
      int base = blocksize >> partition_order;
      for (int p = 0; p < n_partitions; p++) {
        int count = p == 0 ? base - order : base;
        if (count < 0 || idx + count > blocksize) return -13;
        int param = (int)br_get(&br, param_bits);
        if (param == escape) {
          int nbits = (int)br_get(&br, 5);
          if (nbits == 0) {
            for (int i = 0; i < count; i++) res[idx + i] = 0;
          } else {
            for (int i = 0; i < count; i++) res[idx + i] = br_signed(&br, nbits);
          }
        } else {
          // fused Rice inner loop: ONE 64-bit load per sample covers the
          // unary quotient AND the param-bit remainder whenever they fit
          // in the loaded window (always, except pathological quotients
          // near EOF) — vs three per-field loads through br_unary/br_get
          const uint8_t* buf = br.buf;
          int64_t size = (br.nbits + 7) >> 3;
          int64_t pos = br.pos;
          // persistent 64-bit window: bits [pos, pos+avail) sit left-
          // aligned in w (shifted-in low bits are zero, so a clz that
          // runs past avail just triggers a refill).  Typical Rice codes
          // are ~param+2 bits, so one load serves several samples.
          uint64_t w = 0;
          int avail = 0;
          for (int i = 0; i < count; i++) {
            int lead = w ? __builtin_clzll(w) : 64;
            if (lead + 1 + param > avail) {
              int64_t byte = pos >> 3;
              if (byte + 8 <= size) {
                uint64_t raw;
                memcpy(&raw, buf + byte, 8);
                w = __builtin_bswap64(raw) << (pos & 7);
                avail = 64 - (int)(pos & 7);
                lead = w ? __builtin_clzll(w) : 64;
              }
              if (lead + 1 + param > avail) {
                // long quotient / EOF tail: per-field slow path
                br.pos = pos;
                int qv = br_unary(&br);
                if (qv < 0) return -14;
                uint32_t u = ((uint32_t)qv << param) | br_get(&br, param);
                res[idx + i] = (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
                pos = br.pos;
                w = 0;
                avail = 0;
                continue;
              }
            }
            int need = lead + 1 + param;
            uint32_t u = ((uint32_t)lead << param) |
                         (param ? (uint32_t)((w << (lead + 1)) >>
                                             (64 - param)) : 0u);
            res[idx + i] = (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
            pos += need;
            w = need >= 64 ? 0 : w << need;  // need==64: shift-by-64 is UB
            avail -= need;
          }
          br.pos = pos;
        }
        idx += count;
      }
    }

  done_subframe:
    order_out[ci] = order;
    shift_out[ci] = shift;
    wasted_out[ci] = wasted;
    bps_out[ci] = sub_bps;
  }

  // byte align + CRC16
  br.pos = (br.pos + 7) & ~7LL;
  br_get(&br, 16);
  if (br.pos > br.nbits) return -15;

  meta[0] = blocksize;
  meta[1] = chan_assignment;
  meta[2] = nch;
  meta[3] = br.pos;
  return 0;
}

// Parse up to W consecutive frames in ONE call (the batch scheduler's
// window unit).  Per-frame outputs land at strided offsets of the caller's
// window arrays, so the Python side pays one FFI crossing + one set of
// array allocations per lane-window instead of per frame (the per-frame
// wrapper spent more in numpy/ctypes overhead than in the Rice decode
// itself).  Returns the number of frames parsed
// (>= 0); a parse error or EOF simply ends the window early.
int af_flac_parse_window(
    const uint8_t* data, int64_t nbytes, int64_t start_bits,
    int32_t streaminfo_bps, int32_t expect_channels,
    int32_t max_block, int32_t W,
    int32_t* residual,   // [W*ch, max_block]
    int32_t* coeffs,     // [W*ch, 32]
    int32_t* order_out, int32_t* shift_out,   // [W*ch]
    int32_t* wasted_out, int32_t* bps_out,    // [W*ch]
    int64_t* meta) {     // [W, 4]
  int64_t bits = start_bits;
  int32_t ch = expect_channels;
  int f = 0;
  for (; f < W; f++) {
    if (bits >= nbytes * 8 - 15) break;
    int rc = af_flac_parse_frame(
        data, nbytes, bits, streaminfo_bps, expect_channels, max_block,
        residual + (int64_t)f * ch * max_block,
        coeffs + (int64_t)f * ch * 32,
        order_out + (int64_t)f * ch, shift_out + (int64_t)f * ch,
        wasted_out + (int64_t)f * ch, bps_out + (int64_t)f * ch,
        meta + (int64_t)f * 4);
    if (rc != 0) break;
    bits = meta[(int64_t)f * 4 + 3];
  }
  return f;
}

// ---------------------------------------------------------------------------
// MP3 Layer III: full side-info + scalefactor + Huffman frame parse
// ---------------------------------------------------------------------------

struct Mp3Bits {
  const uint8_t* buf;
  int64_t pos;
  int64_t limit;
};

static inline uint32_t mp3_get(Mp3Bits* bs, int n) {
  int64_t p = bs->pos;
  bs->pos = p + n;
  if (bs->pos > bs->limit || n == 0) return 0;
  int64_t first = p >> 3;
  int64_t last = (p + n - 1) >> 3;
  uint64_t w = 0;
  for (int64_t i = first; i <= last; i++) w = (w << 8) | bs->buf[i];
  return (uint32_t)((w >> ((last + 1) * 8 - p - n)) & ((n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1)));
}

// Tables injected from Python at init.
static uint8_t g_scf_long[8 * 23];
static uint8_t g_scf_short[8 * 40];
static uint8_t g_scf_mixed[8 * 40];
static uint8_t g_scf_partitions[3 * 28];
static uint8_t g_scfc_decode[16];
static uint8_t g_scf_mod[24];
static uint8_t g_preamp[10];

int af_mp3_set_l3_tables(const uint8_t* scf_long, const uint8_t* scf_short,
                         const uint8_t* scf_mixed, const uint8_t* parts,
                         const uint8_t* scfc, const uint8_t* mod,
                         const uint8_t* preamp) {
  memcpy(g_scf_long, scf_long, sizeof(g_scf_long));
  memcpy(g_scf_short, scf_short, sizeof(g_scf_short));
  memcpy(g_scf_mixed, scf_mixed, sizeof(g_scf_mixed));
  memcpy(g_scf_partitions, parts, sizeof(g_scf_partitions));
  memcpy(g_scfc_decode, scfc, sizeof(g_scfc_decode));
  memcpy(g_scf_mod, mod, sizeof(g_scf_mod));
  memcpy(g_preamp, preamp, sizeof(g_preamp));
  return 0;
}

struct GrInfo {
  const uint8_t* sfbtab;
  int part_23_length, big_values, scalefac_compress;
  int global_gain, block_type, mixed_block_flag, n_long_sfb, n_short_sfb;
  int table_select[3], region_count[3], subblock_gain[3];
  int preflag, scalefac_scale, count1_table, scfsi;
};

// L3_read_side_info (minimp3.d:487-640).  Returns main_data_begin or -1.
static int mp3_side_info(Mp3Bits* bs, GrInfo* gr, const uint8_t* h) {
  int sr_idx = ((h[2] >> 2) & 3) + (((h[1] >> 3) & 1) + ((h[1] >> 4) & 1)) * 3;
  sr_idx -= (sr_idx != 0);
  int mpeg1 = h[1] & 0x8;
  int mono = (h[3] & 0xC0) == 0xC0;
  int gr_count = mono ? 1 : 2;
  unsigned scfsi = 0;
  int main_data_begin;
  if (mpeg1) {
    gr_count *= 2;
    main_data_begin = (int)mp3_get(bs, 9);
    scfsi = mp3_get(bs, 7 + gr_count);
  } else {
    main_data_begin = (int)(mp3_get(bs, 8 + gr_count) >> gr_count);
  }
  int part_23_sum = 0;
  for (int g = 0; g < gr_count; g++, gr++) {
    if (mono) scfsi <<= 4;
    gr->part_23_length = (int)mp3_get(bs, 12);
    part_23_sum += gr->part_23_length;
    gr->big_values = (int)mp3_get(bs, 9);
    if (gr->big_values > 288) return -1;
    gr->global_gain = (int)mp3_get(bs, 8);
    gr->scalefac_compress = (int)mp3_get(bs, mpeg1 ? 4 : 9);
    gr->sfbtab = g_scf_long + sr_idx * 23;
    gr->n_long_sfb = 22;
    gr->n_short_sfb = 0;
    gr->region_count[0] = gr->region_count[1] = gr->region_count[2] = 0;
    gr->subblock_gain[0] = gr->subblock_gain[1] = gr->subblock_gain[2] = 0;
    gr->mixed_block_flag = 0;
    unsigned tables;
    if (mp3_get(bs, 1)) {
      gr->block_type = (int)mp3_get(bs, 2);
      if (!gr->block_type) return -1;
      gr->mixed_block_flag = (int)mp3_get(bs, 1);
      gr->region_count[0] = 7;
      gr->region_count[1] = 255;
      if (gr->block_type == 2) {
        scfsi &= 0x0F0F;
        if (!gr->mixed_block_flag) {
          gr->region_count[0] = 8;
          gr->sfbtab = g_scf_short + sr_idx * 40;
          gr->n_long_sfb = 0;
          gr->n_short_sfb = 39;
        } else {
          gr->sfbtab = g_scf_mixed + sr_idx * 40;
          gr->n_long_sfb = mpeg1 ? 8 : 6;
          gr->n_short_sfb = 30;
        }
      }
      tables = mp3_get(bs, 10) << 5;
      gr->subblock_gain[0] = (int)mp3_get(bs, 3);
      gr->subblock_gain[1] = (int)mp3_get(bs, 3);
      gr->subblock_gain[2] = (int)mp3_get(bs, 3);
    } else {
      gr->block_type = 0;
      tables = mp3_get(bs, 15);
      gr->region_count[0] = (int)mp3_get(bs, 4);
      gr->region_count[1] = (int)mp3_get(bs, 3);
      gr->region_count[2] = 255;
    }
    gr->table_select[0] = (int)(tables >> 10);
    gr->table_select[1] = (int)((tables >> 5) & 31);
    gr->table_select[2] = (int)(tables & 31);
    gr->preflag = mpeg1 ? (int)mp3_get(bs, 1) : (gr->scalefac_compress >= 500);
    gr->scalefac_scale = (int)mp3_get(bs, 1);
    gr->count1_table = (int)mp3_get(bs, 1);
    gr->scfsi = (int)((scfsi >> 12) & 15);
    scfsi <<= 4;
  }
  if (part_23_sum + bs->pos > bs->limit + (int64_t)main_data_begin * 8)
    return -1;
  return main_data_begin;
}

static void mp3_scalefactors_q(const uint8_t* h, int32_t* ist_pos,
                               BitReader* br, const GrInfo* gr, int ch,
                               int16_t* eq /*[40]*/);

// L3_decode_scalefactors (minimp3.d:648-720) over the maindata reader.
// scf[i] == 2^(eq[i]/4) exactly (integer quarter-exponents; eq <= -20000
// underflows to 0.0f just like the reference's ldexp chain).
static void mp3_scalefactors(const uint8_t* h, int32_t* ist_pos,
                             BitReader* br, const GrInfo* gr, int ch,
                             float* scf /*[40]*/) {
  int16_t eq[40];
  mp3_scalefactors_q(h, ist_pos, br, gr, ch, eq);
  for (int i = 0; i < 40; i++)
    scf[i] = (eq[i] <= -20000) ? 0.0f : (float)exp2((double)eq[i] / 4.0);
}

// Variant emitting the integer QUARTER-EXPONENTS (scf[i] == 2^(eq[i]/4)
// exactly — see the exp2(e/4) above): the device-Huffman path ships these
// as int16 instead of f32 gains (40 x 2 bytes/lane) and reconstructs with
// exp2 on device.
static void mp3_scalefactors_q(const uint8_t* h, int32_t* ist_pos,
                               BitReader* br, const GrInfo* gr, int ch,
                               int16_t* eq /*[40]*/) {
  int32_t iscf[43];
  memset(iscf, 0, sizeof(iscf));
  {
    // inline of mp3_scalefactors' iscf stage
    int mpeg1 = h[1] & 0x8;
    int part_idx = (gr->n_short_sfb ? 1 : 0) + (gr->n_long_sfb ? 0 : 1);
    const uint8_t* scf_partition = g_scf_partitions + part_idx * 28;
    int scf_size[4] = {0, 0, 0, 0};
    long scfsi = gr->scfsi;
    int k = 0;
    if (mpeg1) {
      int part = g_scfc_decode[gr->scalefac_compress];
      scf_size[0] = scf_size[1] = part >> 2;
      scf_size[2] = scf_size[3] = part & 3;
    } else {
      int ist = ((h[3] & 0x10) && ch) ? 1 : 0;
      long sfc = gr->scalefac_compress >> ist;
      k = ist * 3 * 4;
      while (sfc >= 0) {
        long modprod = 1;
        for (int i = 3; i >= 0; i--) {
          scf_size[i] = (int)((sfc / modprod) % g_scf_mod[k + i]);
          modprod *= g_scf_mod[k + i];
        }
        sfc -= modprod;
        k += 4;
      }
      scfsi = -16;
    }
    const uint8_t* scf_count = scf_partition + k;
    int n = 0;
    for (int i = 0; i < 4 && scf_count[i]; i++) {
      int cnt = scf_count[i];
      if (scfsi & 8) {
        for (int j = 0; j < cnt; j++) iscf[n + j] = ist_pos[n + j];
      } else {
        int bits = scf_size[i];
        if (!bits) {
          for (int j = 0; j < cnt; j++) { iscf[n + j] = 0; ist_pos[n + j] = 0; }
        } else {
          int max_scf = (scfsi < 0) ? (1 << bits) - 1 : -1;
          for (int j = 0; j < cnt; j++) {
            int s = (int)br_get(br, bits);
            ist_pos[n + j] = (s == max_scf) ? 255 : s;
            iscf[n + j] = s;
          }
        }
      }
      n += cnt;
      scfsi *= 2;
    }
    iscf[n] = iscf[n + 1] = iscf[n + 2] = 0;
  }
  int scf_shift = gr->scalefac_scale + 1;
  if (gr->n_short_sfb) {
    int sh = 3 - scf_shift;
    for (int i = 0; i < gr->n_short_sfb; i += 3) {
      iscf[gr->n_long_sfb + i + 0] += gr->subblock_gain[0] << sh;
      iscf[gr->n_long_sfb + i + 1] += gr->subblock_gain[1] << sh;
      iscf[gr->n_long_sfb + i + 2] += gr->subblock_gain[2] << sh;
    }
  } else if (gr->preflag) {
    for (int i = 0; i < 10; i++) iscf[11 + i] += g_preamp[i];
  }
  int ms_stereo = (h[3] & 0xE0) == 0x60;
  int gain_exp = gr->global_gain - 4 - 210 - (ms_stereo ? 2 : 0);
  int nb = gr->n_long_sfb + gr->n_short_sfb;
  for (int i = 0; i < 40; i++) eq[i] = -20000;  // 2^(eq/4) -> 0.0f
  for (int i = 0; i < nb; i++) {
    long e = (long)gain_exp - ((long)iscf[i] << scf_shift);
    if (e < -20000) e = -20000;
    if (e > 20000) e = 20000;
    eq[i] = (int16_t)e;
  }
}

// Full-frame Layer III main-data parse: scalefactors + Huffman for every
// granule-channel.  maindata layout mirrors the Python path.
//   q_out    [ngr*nch*576] int32
//   gain_out [ngr*nch*576] float
//   meta_in: [0]=ngr [1]=nch; header: 4 bytes
//   gr_fields: int32[ngr*nch*24] packed GrInfo fields from Python? No —
//   side info is parsed here too, from the frame bytes.
// Returns 0 ok, -1 bad side info (decoder resets), -2 reservoir underflow
// handled by caller (this function is only called when restore succeeded).

// Lean per-frame entry: Python parses side info (it owns the bit-reservoir
// bookkeeping) and passes per-granule parameters; this decodes scalefactors
// + Huffman for every granule-channel in one call.
// gr_params per granule-channel, int32[20]:
//  [0]=part_23_length [1]=big_values [2]=scalefac_compress [3]=global_gain
//  [4]=block_type [5]=mixed [6]=n_long_sfb [7]=n_short_sfb
//  [8..10]=table_select [11..13]=region_count [14..16]=subblock_gain
//  [17]=preflag [18]=scalefac_scale [19]=count1_table ; scfsi in [20]? ->
//  packed as [21] ints with [20]=scfsi.
int af_mp3_granules_scf_huff(
    const uint8_t* hdr4, const uint8_t* maindata, int64_t maindata_len,
    const int32_t* gr_params /* [ngr*nch*21] */,
    const uint8_t* sfbtabs /* [ngr*nch*40] */,
    int32_t ngr, int32_t nch,
    int32_t* ist_pos /* [2*40] persistent */,
    int32_t* q_out, float* gain_out /* [ngr*nch*576] */,
    int32_t* ist_snapshot /* [ngr*40] */) {
  BitReader br = {maindata, maindata_len * 8, 0};
  float scf[40];
  for (int g = 0; g < ngr; g++) {
    for (int ch = 0; ch < nch; ch++) {
      const int32_t* p = gr_params + (int64_t)(g * nch + ch) * 21;
      GrInfo gr;
      gr.part_23_length = p[0];
      gr.big_values = p[1];
      gr.scalefac_compress = p[2];
      gr.global_gain = p[3];
      gr.block_type = p[4];
      gr.mixed_block_flag = p[5];
      gr.n_long_sfb = p[6];
      gr.n_short_sfb = p[7];
      for (int i = 0; i < 3; i++) {
        gr.table_select[i] = p[8 + i];
        gr.region_count[i] = p[11 + i];
        gr.subblock_gain[i] = p[14 + i];
      }
      gr.preflag = p[17];
      gr.scalefac_scale = p[18];
      gr.count1_table = p[19];
      gr.scfsi = p[20];
      const uint8_t* sfb = sfbtabs + (int64_t)(g * nch + ch) * 40;
      gr.sfbtab = sfb;
      int64_t limit = br.pos + gr.part_23_length;
      mp3_scalefactors(hdr4, ist_pos + ch * 40, &br, &gr, ch, scf);
      int32_t ts[3] = {gr.table_select[0], gr.table_select[1],
                       gr.table_select[2]};
      int32_t rc[3] = {gr.region_count[0], gr.region_count[1],
                       gr.region_count[2]};
      uint8_t sfb48[48];
      memset(sfb48, 0, sizeof(sfb48));
      memcpy(sfb48, sfb, 40);
      int64_t end = af_mp3_huffman(
          maindata, maindata_len, br.pos, limit, ts, rc, sfb48, scf,
          gr.big_values, gr.count1_table,
          q_out + (int64_t)(g * nch + ch) * 576,
          gain_out + (int64_t)(g * nch + ch) * 576);
      if (end < 0) return -1;
      br.pos = limit;
    }
    memcpy(ist_snapshot + (int64_t)g * 40, ist_pos + (nch - 1) * 40,
           40 * sizeof(int32_t));
  }
  return 0;
}


// ---------------------------------------------------------------------------
// Full MP3 window parse: header walk + side info + reservoir + scalefactors
// + Huffman + stereo-mix/reorder/window tensor assembly for up to W frames
// of ONE stream in a single call (replaces ~30 Python/ctypes round trips
// per frame in the lockstep batch scheduler).
// ---------------------------------------------------------------------------

static const int kHz[3] = {44100, 48000, 32000};
static const int kHalfRate[2][3][15] = {
    {{0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 72, 80},
     {0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 72, 80},
     {0, 16, 24, 28, 32, 40, 48, 56, 64, 72, 80, 88, 96, 112, 128}},
    {{0, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160},
     {0, 16, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192},
     {0, 16, 32, 48, 64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224}}};

static inline int hdr_valid(const uint8_t* h) {
  return h[0] == 0xFF &&
         ((h[1] & 0xF0) == 0xF0 || (h[1] & 0xFE) == 0xE2) &&
         (((h[1] >> 1) & 3) != 0) && ((h[2] >> 4) != 15) &&
         (((h[2] >> 2) & 3) != 3);
}

static inline int hdr_compare(const uint8_t* h1, const uint8_t* h2) {
  // channel-COUNT consistency (mono bit) is checked on top of minimp3's
  // hdr_compare: every caller compares a candidate frame against the
  // stream's INITIAL header to decide walk continuation, and a mid-stream
  // mono<->stereo splice must stop the walk exactly like the facade
  // (models/mp3.py) and minimp3_ex's MP3D_E_DECODE (minimp3_ex.d:841) —
  // the window parse would otherwise read the frame's side info with the
  // wrong channel layout
  return hdr_valid(h2) && (((h1[1] ^ h2[1]) & 0xFE) == 0) &&
         (((h1[2] ^ h2[2]) & 0x0C) == 0) &&
         ((((h1[2] & 0xF0) == 0) ? 1 : 0) == (((h2[2] & 0xF0) == 0) ? 1 : 0)) &&
         ((((h1[3] & 0xC0) == 0xC0) ? 1 : 0) ==
          (((h2[3] & 0xC0) == 0xC0) ? 1 : 0));
}

static inline int hdr_sample_rate(const uint8_t* h) {
  int hz = kHz[(h[2] >> 2) & 3];
  if (!(h[1] & 0x8)) hz >>= 1;
  if (!(h[1] & 0x10)) hz >>= 1;
  return hz;
}

static inline int hdr_frame_samples(const uint8_t* h) {
  if ((h[1] & 6) == 6) return 384;
  return 1152 >> (((h[1] & 14) == 2) ? 1 : 0);
}

static inline int hdr_frame_bytes(const uint8_t* h, int free_format) {
  int kbps =
      2 * kHalfRate[(h[1] & 0x8) ? 1 : 0][((h[1] >> 1) & 3) - 1][h[2] >> 4];
  int fb = (int)((int64_t)hdr_frame_samples(h) * kbps * 125 /
                 hdr_sample_rate(h));
  if ((h[1] & 6) == 6) fb &= ~3;
  return fb ? fb : free_format;
}

static inline int hdr_padding(const uint8_t* h) {
  if (h[2] & 0x2) return ((h[1] & 6) == 6) ? 4 : 1;
  return 0;
}

// Frame-index walk with side-info-only reservoir simulation (the hot loop
// of models/mp3.py Mp3Decoder._index_and_detect; shape from
// minimp3_ex.d:mp3dec_iterate).  Walks from state[3] while headers match
// hdr0, filling per-frame byte offsets and cumulative output samples.
// Stops at the first non-matching header or stream end -- the python
// caller continues its (rare) resync logic from state[3] with the carried
// reservoir state.  Returns the number of frames indexed.
int64_t af_mp3_index(const uint8_t* data, int64_t nbytes,
                     const uint8_t* hdr0, int32_t free_format_bytes,
                     int32_t layer, int32_t spf_ch, int64_t max_frames,
                     int64_t* offsets, int64_t* samples_acc,
                     int64_t* state /* [4] total, reserv, had_success, off */) {
  int64_t total = state[0];
  int reserv = (int)state[1];
  int had_success = (int)state[2];
  int64_t off = state[3];
  int64_t count = 0;
  while (count < max_frames && off + 4 <= nbytes) {
    const uint8_t* h = data + off;
    if (!hdr_compare(hdr0, h)) break;
    int fb = hdr_frame_bytes(h, free_format_bytes) + hdr_padding(h);
    if (fb <= 0 || off + fb > nbytes) break;
    offsets[count] = off;
    samples_acc[count] = total;
    int ok = 1, avail = 0;
    if (layer == 3 && fb > 4) {
      Mp3Bits bs = {data + off + 4, 0, (int64_t)(fb - 4) * 8};
      if (!(h[1] & 1)) mp3_get(&bs, 16);
      GrInfo grs[4];
      int mdb = mp3_side_info(&bs, grs, h);
      if (mdb < 0) {
        ok = 0;
        avail = 0;
      } else {
        ok = reserv >= mdb;
        int gr_count = (((h[3] & 0xC0) == 0xC0) ? 1 : 2) *
                       ((h[1] & 0x8) ? 2 : 1);
        int used_bits = 0;
        for (int g = 0; g < gr_count; g++) used_bits += grs[g].part_23_length;
        int frame_main = (int)((bs.limit - bs.pos) / 8);
        int have = reserv < mdb ? reserv : mdb;
        int64_t total_bits = (int64_t)(have + frame_main) * 8;
        int consumed = ok ? (int)((8 * have + used_bits + 7) / 8) : 0;
        int64_t a = total_bits / 8 - consumed;
        avail = a > 0 ? (int)a : 0;
      }
    } else if (layer == 3) {
      ok = 0;
      avail = 0;
    }
    if (ok || had_success) {
      total += spf_ch;
      had_success = 1;
    }
    reserv = avail < 511 ? avail : 511;
    off += fb;
    count++;
  }
  state[0] = total;
  state[1] = reserv;
  state[2] = had_success;
  state[3] = off;
  return count;
}

// intensity pan gains (minimp3.d:930-952)
static void mp3_pan_gains(int ipos, int mpeg1, int mpeg2_sh, float* kl,
                          float* kr) {
  static const float pan[14] = {
      0.0f, 1.0f, 0.21132487f, 0.78867513f, 0.36602540f, 0.63397460f,
      0.5f, 0.5f, 0.63397460f, 0.36602540f, 0.78867513f, 0.21132487f,
      1.0f, 0.0f};
  if (mpeg1) {
    *kl = pan[2 * ipos];
    *kr = pan[2 * ipos + 1];
    return;
  }
  float k = (float)exp2(-((double)(((ipos + 1) >> 1) << mpeg2_sh)) / 4.0);
  if (ipos & 1) {
    *kl = k;
    *kr = 1.0f;
  } else {
    *kl = 1.0f;
    *kr = k;
  }
}

// per-coefficient stereo mix (a,b,c,d) vectors (mirrors models/mp3.py
// _stereo_mix; minimp3.d L3_intensity_stereo/L3_midside_stereo semantics)
static void mp3_stereo_mix(const uint8_t* h, const GrInfo* gch,
                           const GrInfo* gr_pair, const int32_t* q_right,
                           const int32_t* ist_pos_right, float* mix
                           /* [4*576] */) {
  for (int i = 0; i < 576; i++) {
    mix[i] = 1.0f;
    mix[576 + i] = 0.0f;
    mix[1152 + i] = 0.0f;
    mix[1728 + i] = 1.0f;
  }
  int mpeg1 = h[1] & 0x8;
  int i_stereo = h[3] & 0x10;
  int ms_flag = h[3] & 0x20;
  int is_ms = (h[3] & 0xE0) == 0x60;
  if (i_stereo) {
    const uint8_t* tab = gch->sfbtab;
    uint8_t sfb[48];
    memset(sfb, 0, sizeof(sfb));
    memcpy(sfb, tab, gch->n_short_sfb ? 40 : 23);
    int n_sfb = gch->n_long_sfb + gch->n_short_sfb;
    int max_blocks = gch->n_short_sfb ? 3 : 1;
    int max_band[3] = {-1, -1, -1};
    int p = 0;
    for (int i = 0; i < n_sfb; i++) {
      int w = sfb[i];
      int any = 0;
      for (int j = 0; j < w; j++) any |= (q_right[p + j] != 0);
      if (any) max_band[i % 3] = i;
      p += w;
    }
    if (gch->n_long_sfb) {
      int m = max_band[0];
      if (max_band[1] > m) m = max_band[1];
      if (max_band[2] > m) m = max_band[2];
      max_band[0] = max_band[1] = max_band[2] = m;
    }
    int32_t ist[40];
    memcpy(ist, ist_pos_right, 40 * sizeof(int32_t));
    int default_pos = mpeg1 ? 3 : 0;
    for (int i = 0; i < max_blocks; i++) {
      int itop = n_sfb - max_blocks + i;
      int prev = itop - max_blocks;
      ist[itop] = (max_band[i] >= prev) ? default_pos : ist[prev];
    }
    int max_pos = mpeg1 ? 7 : 64;
    int mpeg2_sh = gr_pair->scalefac_compress & 1;
    float s = ms_flag ? 1.41421356f : 1.0f;
    p = 0;
    for (int i = 0; sfb[i]; i++) {
      int w = sfb[i];
      int ipos = ist[i];
      if (i > max_band[i % 3] && ipos < max_pos) {
        float kl, kr;
        mp3_pan_gains(ipos, mpeg1 ? 1 : 0, mpeg2_sh, &kl, &kr);
        for (int j = 0; j < w && p + j < 576; j++) {
          mix[p + j] = kl * s;
          mix[576 + p + j] = 0.0f;
          mix[1152 + p + j] = kr * s;
          mix[1728 + p + j] = 0.0f;
        }
      } else if (ms_flag) {
        for (int j = 0; j < w && p + j < 576; j++) {
          mix[p + j] = 1.0f;
          mix[576 + p + j] = 1.0f;
          mix[1152 + p + j] = 1.0f;
          mix[1728 + p + j] = -1.0f;
        }
      }
      p += w;
    }
  } else if (is_ms) {
    for (int i = 0; i < 576; i++) {
      mix[i] = 1.0f;
      mix[576 + i] = 1.0f;
      mix[1152 + i] = 1.0f;
      mix[1728 + i] = -1.0f;
    }
  }
}

// short-block reorder permutation (models/mp3.py _reorder_perm_full;
// minimp3.d:984-1000): new[i] = old[perm[i]]
static void mp3_reorder_perm(const GrInfo* gr, int n_long_bands,
                             int32_t* perm /* [576] */) {
  for (int i = 0; i < 576; i++) perm[i] = i;
  if (!gr->n_short_sfb) return;
  int src = n_long_bands * 18;
  int dst = src;
  uint8_t sfb[48];
  memset(sfb, 0, sizeof(sfb));
  memcpy(sfb, gr->sfbtab, 40);
  int i = gr->n_long_sfb;
  while (sfb[i]) {
    int len = sfb[i];
    for (int j = 0; j < len; j++) {
      if (dst + 3 > 576 || src + 2 * len + j >= 576) return;
      perm[dst] = src + j;
      perm[dst + 1] = src + len + j;
      perm[dst + 2] = src + 2 * len + j;
      dst += 3;
    }
    src += 3 * len;
    i += 3;
  }
}

enum { WIN_NORMAL = 0, WIN_START = 1, WIN_SHORT = 2, WIN_STOP = 3 };

// Parse up to max_frames frames of one stream starting at byte `off`.
// Writes window tensors at frame slots [0, n).  Returns the number of
// frames CONSUMED (>= number decoded; silent frames consume but emit
// flags=0), or 0 at EOF/stream mismatch.  State in/out: reservoir buffer
// (511 bytes) + length, ist_pos [2*40].
//
// The stereo mix (mid/side + intensity) and the short-block reorder are
// applied HERE, during tensor assembly: they are per-coefficient float
// muls / index copies that cost nothing on the host but would cost a
// [B,G,4,576] f32 upload + a device gather per window if shipped to the
// device.
int af_mp3_parse_window(
    const uint8_t* data, int64_t nbytes, int64_t off, const uint8_t* hdr0,
    int32_t max_frames, int32_t free_format_bytes,
    uint8_t* reserv_buf /* [511] */, int32_t* reserv_len,
    int32_t* ist_pos /* [2*40] */,
    float* xq_out /* [W, ngr, nch, 576]: sign(q)*|q|^(4/3)*gain, the
                      requantized spectrum, stereo-mixed and reordered
                      (device dequant/mix/reorder fused here) */,
    int32_t* aa_out /* [W, ngr, nch] */,
    int32_t* wt_out /* [W, ngr, nch, 32] */,
    uint8_t* flags /* [W]: bit0 = has output, bit1 = has short blocks */,
    int64_t* new_off) {
  int mpeg1 = hdr0[1] & 0x8;
  int nch = ((hdr0[3] & 0xC0) == 0xC0) ? 1 : 2;
  int ngr = mpeg1 ? 2 : 1;
  int sr_idx_my =
      (((hdr0[2] >> 2) & 3) + (((hdr0[1] >> 3) & 1) + ((hdr0[1] >> 4) & 1)) * 3);
  int n_long_bands_base = (sr_idx_my == 2) ? 4 : 2;  // mixed<<(idx==2)
  uint8_t maindata[4608];
  int32_t q_i[576];
  float gains_l[576];
  float scf[40];
  // |q|^(4/3) lookup for small magnitudes (covers virtually all samples)
  static float pow43[256];
  static int pow43_init = 0;
  if (!pow43_init) {
    for (int i = 0; i < 256; i++) pow43[i] = (float)pow((double)i, 4.0 / 3.0);
    pow43_init = 1;
  }
  int w = 0;
  for (; w < max_frames; w++) {
    flags[w] = 0;
    if (off + 4 > nbytes) break;
    const uint8_t* h = data + off;
    if (!hdr_compare(hdr0, h)) break;
    int fb = hdr_frame_bytes(h, free_format_bytes) + hdr_padding(h);
    if (fb <= 4 || off + fb > nbytes) break;
    Mp3Bits bs = {data + off + 4, 0, (fb - 4) * 8};
    if (!(h[1] & 1)) mp3_get(&bs, 16);
    GrInfo grs[4];
    int main_data_begin = mp3_side_info(&bs, grs, h);
    if (main_data_begin < 0) {
      // corrupt side info: reset reservoir/scalefactor state, consume frame
      *reserv_len = 0;
      memset(ist_pos, 0, 80 * sizeof(int32_t));
      off += fb;
      continue;
    }
    int side_bytes = (int)(bs.pos / 8);
    const uint8_t* frame_main = data + off + 4 + side_bytes;
    int frame_main_len = fb - 4 - side_bytes;
    int have = *reserv_len < main_data_begin ? *reserv_len : main_data_begin;
    int md_len = have + frame_main_len;
    if (md_len > (int)sizeof(maindata)) { break; }
    if (have)
      memcpy(maindata, reserv_buf + *reserv_len - have, have);
    memcpy(maindata + have, frame_main, frame_main_len);
    int success = (*reserv_len >= main_data_begin);

    int64_t br_pos = 0;
    if (success) {
      int frame_short = 0;
      for (int g = 0; g < ngr; g++) {
        int32_t ist_snapshot[40];
        int32_t perm_l[2][576];
        int has_perm[2] = {0, 0};
        for (int ch = 0; ch < nch; ch++) {
          GrInfo* gr = &grs[g * nch + ch];
          BitReader br = {maindata, (int64_t)md_len * 8, br_pos};
          int64_t limit = br_pos + gr->part_23_length;
          mp3_scalefactors(h, ist_pos + ch * 40, &br, gr, ch, scf);
          int32_t ts[3] = {gr->table_select[0], gr->table_select[1],
                           gr->table_select[2]};
          int32_t rc[3] = {gr->region_count[0], gr->region_count[1],
                           gr->region_count[2]};
          uint8_t sfb48[48];
          memset(sfb48, 0, sizeof(sfb48));
          memcpy(sfb48, gr->sfbtab, gr->n_short_sfb ? 40 : 23);
          float* qd =
              xq_out + (((int64_t)w * ngr + g) * nch + ch) * 576;
          int64_t end = af_mp3_huffman(maindata, md_len, br.pos, limit, ts,
                                       rc, sfb48, scf, gr->big_values,
                                       gr->count1_table, q_i, gains_l);
          if (end < 0) {
            success = 0;
            break;
          }
          for (int i = 0; i < 576; i++) {
            int v = q_i[i];
            int m = v < 0 ? -v : v;
            float p = (m < 256) ? pow43[m] : (float)pow((double)m, 4.0 / 3.0);
            qd[i] = (v < 0 ? -p : p) * gains_l[i];
          }
          br_pos = limit;
          // assembly: aa bands / reorder perm / window types
          int n_long_bands =
              gr->mixed_block_flag ? n_long_bands_base : 0;
          int32_t* wd = wt_out + (((int64_t)w * ngr + g) * nch + ch) * 32;
          if (gr->n_short_sfb) {
            flags[w] |= 2;
            frame_short = 1;
            aa_out[((int64_t)w * ngr + g) * nch + ch] = n_long_bands - 1;
            mp3_reorder_perm(gr, n_long_bands, perm_l[ch]);
            has_perm[ch] = 1;
            for (int i = 0; i < 32; i++)
              wd[i] = (i < n_long_bands) ? WIN_NORMAL : WIN_SHORT;
          } else {
            aa_out[((int64_t)w * ngr + g) * nch + ch] = 31;
            has_perm[ch] = 0;
            int wt = WIN_NORMAL;
            if (gr->block_type == 3) wt = WIN_STOP;
            else if (gr->block_type == 1) wt = WIN_START;
            for (int i = 0; i < 32; i++) wd[i] = wt;
          }
        }
        if (!success) break;
        memcpy(ist_snapshot, ist_pos + (nch - 1) * 40, 40 * sizeof(int32_t));
        // stereo mix for this granule (applied in place: l' = a·l + b·r,
        // r' = c·l + d·r, same f32 ops/order as the device mix it replaces)
        float* qd0 = xq_out + (((int64_t)w * ngr + g) * nch + 0) * 576;
        if (nch == 2) {
          float mixv[4 * 576];
          mp3_stereo_mix(h, &grs[g * nch], &grs[g * nch + 1], q_i,
                         ist_snapshot, mixv);
          float* qd1 = qd0 + 576;
          for (int i = 0; i < 576; i++) {
            float l = qd0[i], r = qd1[i];
            qd0[i] = mixv[i] * l + mixv[576 + i] * r;
            qd1[i] = mixv[1152 + i] * l + mixv[1728 + i] * r;
          }
        }
        // short-block reorder (after the mix, matching the device order):
        // new[i] = old[perm[i]]
        for (int ch = 0; ch < nch; ch++) {
          if (!has_perm[ch]) continue;
          float tmp[576];
          float* qd = qd0 + ch * 576;
          const int32_t* p = perm_l[ch];
          for (int i = 0; i < 576; i++) tmp[i] = qd[p[i]];
          memcpy(qd, tmp, sizeof(tmp));
        }
      }
      if (success) flags[w] |= 1;
    }
    // reservoir save (L3_save_reservoir)
    int pos_bytes = success ? (int)((br_pos + 7) / 8) : 0;
    int remains = md_len - pos_bytes;
    if (remains > 511) {
      pos_bytes += remains - 511;
      remains = 511;
    }
    if (remains < 0) remains = 0;
    memmove(reserv_buf, maindata + pos_bytes, remains);
    *reserv_len = remains;
    off += fb;
  }
  *new_off = off;
  return w;
}

// Packed variant for the DEVICE-Huffman pipeline: the host stops at the
// scalefactor decode and emits each granule-channel's Huffman BIT REGION
// verbatim (byte-copied out of the reservoir-spliced maindata into a fixed
// per-lane ROW of big-endian uint32 words) plus the side info the device
// FSM needs.  The upload then approaches the compressed size instead of
// the dequantized-spectrum size, which matters wherever the host link
// binds.  Streams using
// intensity stereo (header bit 0x10) must use the classic path: their
// stereo mix depends on the decoded right-channel spectrum.
//
// bits_out is laid out [W*ngr*nch lanes, LANE_WORDS=132] uint32 (big-endian
// bit order within each word); part_23_length <= 4095 bits = 129 words,
// plus 2 zero pad words for lookahead.  meta int32[16] per lane:
//   0 span_words (words written incl. pad; 0 for inactive lanes)
//   1 bit_start  (0..7: first Huffman bit within the row)
//   2 bit_limit  (one past the region: bit_start + part23_remaining)
//   3 big_values (pairs)
//   4 bnd0  5 bnd1 (first sfb index of Huffman region 1 / 2)
//   6 tab0  7 tab1  8 tab2  (big-values table ids)
//   9 count1_table (0/1)
//  10 pattern_id  (kind*16 + sr_idx_my; kind 0 long / 1 short / 2 mixed)
//  11..15 reserved (0)
// scf_out: int16 quarter-exponents [W*ngr*nch, 40]; gain = 2^(eq/4).
#define AF_MP3_LANE_WORDS 132
int af_mp3_parse_window_packed(
    const uint8_t* data, int64_t nbytes, int64_t off, const uint8_t* hdr0,
    int32_t max_frames, int32_t free_format_bytes,
    uint8_t* reserv_buf /* [511] */, int32_t* reserv_len,
    int32_t* ist_pos /* [2*40] */,
    uint32_t* bits_out /* [W*ngr*nch, 132] BE words */,
    int32_t* max_words /* [1] out: max span over lanes this call */,
    int32_t* meta_out /* [W*ngr*nch, 16] */,
    int16_t* scf_out /* [W*ngr*nch, 40] quarter-exponents */,
    int16_t* ist_out /* [W*ngr, 40] right-ch ist positions, NULL ok */,
    int32_t* aa_out /* [W, ngr, nch] */,
    int32_t* wt_out /* [W, ngr, nch, 32] */,
    uint8_t* flags /* [W] */, int64_t* new_off) {
  int mpeg1 = hdr0[1] & 0x8;
  int nch = ((hdr0[3] & 0xC0) == 0xC0) ? 1 : 2;
  int ngr = mpeg1 ? 2 : 1;
  int sr_idx_my =
      (((hdr0[2] >> 2) & 3) + (((hdr0[1] >> 3) & 1) + ((hdr0[1] >> 4) & 1)) * 3);
  int n_long_bands_base = (sr_idx_my == 2) ? 4 : 2;
  uint8_t maindata[4608];
  int mw = 0;
  int w = 0;
  for (; w < max_frames; w++) {
    flags[w] = 0;
    if (off + 4 > nbytes) break;
    const uint8_t* h = data + off;
    if (!hdr_compare(hdr0, h)) break;
    if (nch == 2 && (h[3] & 0x10)) {
      // intensity-stereo frame: decoded on the device via the two-phase
      // window (spectra first, then the per-band pan mix built from the
      // right channel's ist positions + content extent — minimp3.d:963);
      // the flag tells the scheduler to ship the ist plane this window
      flags[w] |= 4;
    }
    int fb = hdr_frame_bytes(h, free_format_bytes) + hdr_padding(h);
    if (fb <= 4 || off + fb > nbytes) break;
    Mp3Bits bs = {data + off + 4, 0, (fb - 4) * 8};
    if (!(h[1] & 1)) mp3_get(&bs, 16);
    GrInfo grs[4];
    int main_data_begin = mp3_side_info(&bs, grs, h);
    if (main_data_begin < 0) {
      *reserv_len = 0;
      memset(ist_pos, 0, 80 * sizeof(int32_t));
      off += fb;
      continue;
    }
    int side_bytes = (int)(bs.pos / 8);
    const uint8_t* frame_main = data + off + 4 + side_bytes;
    int frame_main_len = fb - 4 - side_bytes;
    int have = *reserv_len < main_data_begin ? *reserv_len : main_data_begin;
    int md_len = have + frame_main_len;
    if (md_len > (int)sizeof(maindata)) break;
    if (have) memcpy(maindata, reserv_buf + *reserv_len - have, have);
    memcpy(maindata + have, frame_main, frame_main_len);
    int success = (*reserv_len >= main_data_begin);

    int64_t br_pos = 0;
    if (success) {
      for (int g = 0; g < ngr && success; g++) {
        for (int ch = 0; ch < nch; ch++) {
          GrInfo* gr = &grs[g * nch + ch];
          BitReader br = {maindata, (int64_t)md_len * 8, br_pos};
          int64_t limit = br_pos + gr->part_23_length;
          int lane = (w * ngr + g) * nch + ch;
          mp3_scalefactors_q(h, ist_pos + ch * 40, &br, gr, ch,
                             scf_out + (int64_t)lane * 40);
          int32_t* m = meta_out + (int64_t)lane * 16;
          // lane row: bytes [start_bit/8, ceil(limit/8)) as BE words + pad
          int64_t start_bit = br.pos;
          if (start_bit > limit) start_bit = limit;
          int64_t start_byte = start_bit >> 3;
          int64_t end_byte = (limit + 7) >> 3;
          if (end_byte > md_len) end_byte = md_len;
          if (end_byte < start_byte) end_byte = start_byte;
          int span = (int)(end_byte - start_byte);
          uint32_t* row = bits_out + (int64_t)lane * AF_MP3_LANE_WORDS;
          const uint8_t* src = maindata + start_byte;
          int nw = (span + 3) >> 2;
          for (int k = 0; k < nw; k++) {
            int b0 = 4 * k;
            uint32_t v = 0;
            for (int b = 0; b < 4; b++) {
              uint32_t byte = (b0 + b < span) ? src[b0 + b] : 0;
              v = (v << 8) | byte;
            }
            row[k] = v;
          }
          row[nw] = 0;
          row[nw + 1] = 0;
          if (nw + 2 > mw) mw = nw + 2;
          m[0] = nw + 2;
          m[1] = (int32_t)(start_bit - start_byte * 8);
          m[2] = m[1] + (int32_t)(limit - start_bit);
          m[3] = gr->big_values;
          m[4] = gr->region_count[0] + 1;
          m[5] = gr->region_count[0] + gr->region_count[1] + 2;
          m[6] = gr->table_select[0];
          m[7] = gr->table_select[1];
          m[8] = gr->table_select[2];
          m[9] = gr->count1_table;
          // pattern id uses the UNCOLLAPSED sr index: the mixed-block
          // n_long_bands (2 vs 4) depends on sr_idx_my==2, which the
          // collapsed table index cannot distinguish
          int kind = gr->n_short_sfb ? (gr->n_long_sfb ? 2 : 1) : 0;
          m[10] = kind * 16 + sr_idx_my;
          // stereo-mode bits: 0 mid/side ((h3&0xE0)==0x60), 1 intensity
          // header bit, 2 raw ms bit (h3&0x20: the ist branch's sqrt2
          // scale tests this, minimp3.d:977), 3 right-granule
          // scalefac_compress parity (MPEG-2 pan shift)
          m[11] = (((h[3] & 0xE0) == 0x60) ? 1 : 0) |
                  ((nch == 2 && (h[3] & 0x10)) ? 2 : 0) |
                  ((h[3] & 0x20) ? 4 : 0) |
                  ((nch == 2 && (grs[g * nch + 1].scalefac_compress & 1))
                       ? 8 : 0);
          m[12] = gr->block_type;  // device builds wtype/aa from this
          for (int i = 13; i < 16; i++) m[i] = 0;
          // aa / window types (same as the classic path)
          int n_long_bands = gr->mixed_block_flag ? n_long_bands_base : 0;
          int32_t* wd = wt_out + (((int64_t)w * ngr + g) * nch + ch) * 32;
          if (gr->n_short_sfb) {
            flags[w] |= 2;
            aa_out[((int64_t)w * ngr + g) * nch + ch] = n_long_bands - 1;
            for (int i = 0; i < 32; i++)
              wd[i] = (i < n_long_bands) ? WIN_NORMAL : WIN_SHORT;
          } else {
            aa_out[((int64_t)w * ngr + g) * nch + ch] = 31;
            int wt = WIN_NORMAL;
            if (gr->block_type == 3) wt = WIN_STOP;
            else if (gr->block_type == 1) wt = WIN_START;
            for (int i = 0; i < 32; i++) wd[i] = wt;
          }
          br_pos = limit;
        }
        if (nch == 2 && ist_out) {
          // post-right-scalefactor snapshot of the persistent intensity
          // positions (the classic path's ist_snapshot, one per granule)
          int16_t* dst = ist_out + ((int64_t)w * ngr + g) * 40;
          const int32_t* sp = ist_pos + 40;
          for (int i = 0; i < 40; i++) dst[i] = (int16_t)sp[i];
        }
      }
      if (success) flags[w] |= 1;
    }
    int pos_bytes = success ? (int)((br_pos + 7) / 8) : 0;
    int remains = md_len - pos_bytes;
    if (remains > 511) {
      pos_bytes += remains - 511;
      remains = 511;
    }
    if (remains < 0) remains = 0;
    memmove(reserv_buf, maindata + pos_bytes, remains);
    *reserv_len = remains;
    off += fb;
  }
  *max_words = mw;
  *new_off = off;
  return w;
}



// ---------------------------------------------------------------------------
// Opus range decoder (RFC 6716 section 4.1) — exact mirror of
// models/opus.py:RangeDecoder (ec_dec), validated against libopus range
// fingerprints by tests/test_opus_celt.py.
// ---------------------------------------------------------------------------

typedef struct {
  const uint8_t* buf;
  int32_t storage;
  int32_t offs, end_offs;
  int32_t end_bound;  // raw-bit tail boundary (RangeDecoder.rebound_end)
  uint32_t end_window;
  int32_t nend_bits;
  int32_t nbits_total;
  uint32_t rng, val, ext, rem;
} EcDec;

static inline uint32_t ec_read_byte(EcDec* d) {
  return d->offs < d->storage ? d->buf[d->offs++] : 0;
}

static inline uint32_t ec_read_byte_from_end(EcDec* d) {
  if (d->end_offs < d->end_bound) {
    d->end_offs++;
    return d->buf[d->end_bound - d->end_offs];
  }
  return 0;
}

static void ec_normalize(EcDec* d) {
  while (d->rng <= (1u << 23)) {
    d->nbits_total += 8;
    d->rng <<= 8;
    uint32_t sym = d->rem;
    d->rem = ec_read_byte(d);
    sym = ((sym << 8) | d->rem) >> 1;
    d->val = ((d->val << 8) + (0xFFu & ~sym)) & ((1u << 31) - 1);
  }
}

static void ec_init(EcDec* d, const uint8_t* buf, int32_t len) {
  d->buf = buf;
  d->storage = len;
  d->offs = 0;
  d->end_offs = 0;
  d->end_bound = len;
  d->end_window = 0;
  d->nend_bits = 0;
  d->nbits_total = 33 - 24;
  d->rng = 1u << 7;
  d->rem = ec_read_byte(d);
  d->val = d->rng - 1 - (d->rem >> 1);
  d->ext = 0;
  ec_normalize(d);
}

static inline uint32_t ec_decode(EcDec* d, uint32_t ft) {
  d->ext = d->rng / ft;
  uint32_t s = d->val / d->ext;
  return ft - 1 - (s < ft - 1 ? s : ft - 1);
}

static inline uint32_t ec_decode_bin(EcDec* d, int bits) {
  d->ext = d->rng >> bits;
  uint32_t s = d->val / d->ext;
  uint32_t m = (1u << bits) - 1;
  return m - (s < m ? s : m);
}

static inline void ec_update(EcDec* d, uint32_t fl, uint32_t fh,
                             uint32_t ft) {
  uint32_t s = d->ext * (ft - fh);
  d->val -= s;
  d->rng = fl > 0 ? d->ext * (fh - fl) : d->rng - s;
  ec_normalize(d);
}

static inline int ec_dec_bit_logp(EcDec* d, int logp) {
  uint32_t r = d->rng;
  uint32_t v = d->val;
  uint32_t s = r >> logp;
  int ret = v < s;
  if (!ret) d->val = v - s;
  d->rng = ret ? s : r - s;
  ec_normalize(d);
  return ret;
}

// ff-style cdf model: model[0] = ft, model[1..] cumulative highs
static inline int ec_dec_cdf(EcDec* d, const uint16_t* model) {
  uint32_t total = model[0];
  uint32_t fs = ec_decode(d, total);
  int k = 0;
  while (model[1 + k] <= fs) k++;
  ec_update(d, k ? model[k] : 0, model[1 + k], total);
  return k;
}

static inline uint32_t ec_dec_bits(EcDec* d, int bits) {
  uint32_t window = d->end_window;
  int avail = d->nend_bits;
  while (avail < bits) {
    window |= ec_read_byte_from_end(d) << avail;
    avail += 8;
  }
  uint32_t ret = window & ((1u << bits) - 1);
  window >>= bits;
  avail -= bits;
  d->end_window = window;
  d->nend_bits = avail;
  d->nbits_total += bits;
  return ret;
}

static inline int ec_ilog(uint32_t v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

static uint32_t ec_dec_uint(EcDec* d, uint32_t ft) {
  ft--;
  int ftb = ec_ilog(ft);
  if (ftb > 8) {
    ftb -= 8;
    uint32_t ft1 = (ft >> ftb) + 1;
    uint32_t t = ec_decode(d, ft1);
    ec_update(d, t, t + 1, ft1);
    t = (t << ftb) | ec_dec_bits(d, ftb);
    return t <= ft ? t : ft;
  }
  ft++;
  uint32_t t = ec_decode(d, ft);
  ec_update(d, t, t + 1, ft);
  return t;
}

static inline int ec_tell(const EcDec* d) {
  return d->nbits_total - ec_ilog(d->rng);
}

static int ec_tell_frac(const EcDec* d) {
  uint32_t nbits = d->nbits_total << 3;
  int l = ec_ilog(d->rng);
  uint32_t r = d->rng >> (l - 16);
  for (int i = 0; i < 3; i++) {
    r = (r * r) >> 15;
    int b = r >> 16;
    l = (l << 1) | b;
    r >>= b;
  }
  return nbits - l;
}

static int ec_dec_laplace(EcDec* d, uint32_t fs, int decay) {
  int value = 0;
  uint32_t low = 0;
  uint32_t center = ec_decode_bin(d, 15);
  if (center >= fs) {
    value++;
    low = fs;
    fs = 1 + (((32768 - 32 - fs) * (uint32_t)(16384 - decay)) >> 15);
    while (fs > 1 && center >= low + 2 * fs) {
      value++;
      fs *= 2;
      low += fs;
      fs = (((fs - 2) * (uint32_t)decay) >> 15) + 1;
    }
    if (fs <= 1) {
      int distance = (center - low) >> 1;
      value += distance;
      low += 2 * distance;
    }
    if (center < low + fs) value = -value;
    else low += fs;
  }
  uint32_t high = low + fs < 32768 ? low + fs : 32768;
  ec_update(d, low, high, 32768);
  return value;
}

static int ec_dec_step(EcDec* d, int k0) {
  uint32_t total = (k0 + 1) * 3 + k0;
  uint32_t fs = ec_decode(d, total);
  int k = fs < (uint32_t)((k0 + 1) * 3) ? (int)(fs / 3)
                                        : (int)fs - (k0 + 1) * 2;
  if (k <= k0) ec_update(d, 3 * k, 3 * (k + 1), total);
  else ec_update(d, (k - 1 - k0) + 3 * (k0 + 1),
                 (k - k0) + 3 * (k0 + 1), total);
  return k;
}

static uint32_t isqrt_u32(uint32_t v) {
  uint32_t r = (uint32_t)sqrt((double)v);
  while (r * r > v) r--;
  while ((r + 1) * (r + 1) <= v) r++;
  return r;
}

static int ec_dec_tri(EcDec* d, int qn) {
  uint32_t total = ((qn >> 1) + 1) * ((qn >> 1) + 1);
  uint32_t center = ec_decode(d, total);
  uint32_t k, low, fs;
  if (center < total >> 1) {
    k = (isqrt_u32(8 * center + 1) - 1) >> 1;
    low = k * (k + 1) >> 1;
    fs = k + 1;
  } else {
    k = (2 * (qn + 1) - isqrt_u32(8 * (total - center - 1) + 1)) >> 1;
    low = total - ((qn + 1 - k) * (qn + 2 - k) >> 1);
    fs = qn + 1 - k;
  }
  ec_update(d, low, low + fs, total);
  return (int)k;
}


// ---------------------------------------------------------------------------
// CELT symbol stage in C (mirror of models/celt.py, which is validated
// bit-exactly against libopus).  Python passes the static tables once and
// calls af_celt_decode_symbols per frame; synthesis stays in
// Python/device (ops/celt_dsp.py).
// ---------------------------------------------------------------------------

#define CELT_MAX_BANDS 21

static uint8_t cg_freq_bands[22], cg_freq_range[21], cg_log_freq_range[21];
static uint16_t cg_model_tapset[8], cg_model_spread[8],
    cg_model_alloc_trim[16], cg_model_energy_small[8];
static double cg_mean_energy[25], cg_alpha[4], cg_beta[4], cg_window[120],
    cg_pf_taps[9];
static uint8_t cg_coarse_dist[4 * 2 * 42];
static int8_t cg_tf_select[4 * 2 * 2 * 2];
static uint8_t cg_static_alloc[11 * 21], cg_static_caps[4 * 2 * 21];
static uint8_t cg_cache_bits[392];
static int16_t cg_cache_index[105];
static uint8_t cg_log2_frac[24], cg_bit_ilv[16], cg_bit_dilv[16],
    cg_hadamard[30];
static uint16_t cg_qn_exp2[8];
static uint64_t cg_pvq_u[16 * 178];

int af_celt_set_tables(const uint8_t* freq_bands, const uint8_t* freq_range,
                       const uint8_t* log_freq_range,
                       const uint16_t* model_tapset,
                       const uint16_t* model_spread,
                       const uint16_t* model_alloc_trim,
                       const uint16_t* model_energy_small,
                       const double* mean_energy, const double* alpha,
                       const double* beta, const double* window,
                       const double* pf_taps, const uint8_t* coarse_dist,
                       const int8_t* tf_select, const uint8_t* static_alloc,
                       const uint8_t* static_caps, const uint8_t* cache_bits,
                       const int16_t* cache_index, const uint8_t* log2_frac,
                       const uint8_t* bit_ilv, const uint8_t* bit_dilv,
                       const uint8_t* hadamard, const uint16_t* qn_exp2,
                       const uint64_t* pvq_u) {
  memcpy(cg_freq_bands, freq_bands, 22);
  memcpy(cg_freq_range, freq_range, 21);
  memcpy(cg_log_freq_range, log_freq_range, 21);
  memcpy(cg_model_tapset, model_tapset, 5 * 2);
  memcpy(cg_model_spread, model_spread, 5 * 2);
  memcpy(cg_model_alloc_trim, model_alloc_trim, 12 * 2);
  memcpy(cg_model_energy_small, model_energy_small, 4 * 2);
  memcpy(cg_mean_energy, mean_energy, 25 * 8);
  memcpy(cg_alpha, alpha, 4 * 8);
  memcpy(cg_beta, beta, 4 * 8);
  memcpy(cg_window, window, 120 * 8);
  memcpy(cg_pf_taps, pf_taps, 9 * 8);
  memcpy(cg_coarse_dist, coarse_dist, 4 * 2 * 42);
  memcpy(cg_tf_select, tf_select, 32);
  memcpy(cg_static_alloc, static_alloc, 11 * 21);
  memcpy(cg_static_caps, static_caps, 4 * 2 * 21);
  memcpy(cg_cache_bits, cache_bits, 392);
  memcpy(cg_cache_index, cache_index, 105 * 2);
  memcpy(cg_log2_frac, log2_frac, 24);
  memcpy(cg_bit_ilv, bit_ilv, 16);
  memcpy(cg_bit_dilv, bit_dilv, 16);
  memcpy(cg_hadamard, hadamard, 30);
  memcpy(cg_qn_exp2, qn_exp2, 8 * 2);
  memcpy(cg_pvq_u, pvq_u, 16 * 178 * 8);
  return 0;
}

static inline uint64_t pvq_u_at(int n, int k) {
  int a = n < k ? n : k;
  int b = n < k ? k : n;
  return cg_pvq_u[a * 178 + b];
}
static inline uint64_t pvq_v_at(int n, int k) {
  return pvq_u_at(n, k) + pvq_u_at(n, k + 1);
}

static inline int celt_cos_c(int x) {
  x = (x * x + 4096) >> 13;
  int t2 = ((-626 * x) + 16384) >> 15;
  int t1 = ((x * (8277 + t2)) + 16384) >> 15;
  int t0 = ((x * (-7651 + t1)) + 16384) >> 15;
  return 1 + (32767 - x) + t0;
}

static inline int celt_log2tan_c(int isin, int icos) {
  int lc = ec_ilog((uint32_t)icos);
  int ls = ec_ilog((uint32_t)isin);
  icos <<= 15 - lc;
  isin <<= 15 - ls;
  int a = ((isin * -2597) + 16384) >> 15;
  int b = ((isin * (a + 7932)) + 16384) >> 15;
  int c = ((icos * -2597) + 16384) >> 15;
  int e = ((icos * (c + 7932)) + 16384) >> 15;
  return (ls - lc) * 2048 + b - e;  // ls-lc may be negative: no << (UB)
}

static inline int cdiv_c(int a, int b) { return a / b; }

typedef struct {
  // persistent
  double* energy;        // [2*21]
  double* prev_energy;   // [2*2*21]
  int32_t* collapse;     // [2*21]
  uint32_t* seed;
  // per-frame
  int coded_channels, startband, endband, framebits, duration;
  int blocks, blocksize;
  int spread, intensitystereo, dualstereo, codedbands, anticollapse_bit;
  int remaining, remaining2;
  int tf_change[CELT_MAX_BANDS];
  int pulses[CELT_MAX_BANDS];
  int fine_bits[CELT_MAX_BANDS], fine_priority[CELT_MAX_BANDS];
  float* coeffs;         // [2*960]
} CeltC;

static uint32_t celt_rng_c(CeltC* s) {
  *s->seed = 1664525u * (*s->seed) + 1013904223u;
  return *s->seed;
}

static void celt_coarse_c(CeltC* s, EcDec* d) {
  double alpha, beta;
  const uint8_t* model;
  if (ec_tell(d) + 3 <= s->framebits && ec_dec_bit_logp(d, 3)) {
    alpha = 0.0;
    beta = 1.0 - 4915.0 / 32768.0;
    model = cg_coarse_dist + (s->duration * 2 + 1) * 42;
  } else {
    alpha = cg_alpha[s->duration];
    beta = 1.0 - cg_beta[s->duration];
    model = cg_coarse_dist + (s->duration * 2) * 42;
  }
  double prev[2] = {0.0, 0.0};
  for (int i = 0; i < CELT_MAX_BANDS; i++) {
    for (int ch = 0; ch < s->coded_channels; ch++) {
      if (i < s->startband || i >= s->endband) {
        s->energy[ch * 21 + i] = 0.0;
        continue;
      }
      int avail = s->framebits - ec_tell(d);
      double value;
      if (avail >= 15) {
        int k = (i < 20 ? i : 20) << 1;
        value = ec_dec_laplace(d, (uint32_t)model[k] << 7, model[k + 1] << 6);
      } else if (avail >= 2) {
        int x = ec_dec_cdf(d, cg_model_energy_small);
        value = (double)((x >> 1) ^ -(x & 1));
      } else if (avail >= 1) {
        value = -(double)ec_dec_bit_logp(d, 1);
      } else {
        value = -1.0;
      }
      double e = s->energy[ch * 21 + i];
      e = (e > -9.0 ? e : -9.0) * alpha + prev[ch] + value;
      s->energy[ch * 21 + i] = e;
      prev[ch] += beta * value;
    }
  }
}

static void celt_tf_c(CeltC* s, EcDec* d, int transient) {
  int diff = 0, tf_changed = 0, tf_sel = 0;
  int bits = transient ? 2 : 4;
  int consumed = ec_tell(d);
  int tf_select_bit =
      (s->duration != 0 && consumed + bits + 1 <= s->framebits);
  for (int i = s->startband; i < s->endband; i++) {
    if (consumed + bits + tf_select_bit <= s->framebits) {
      diff ^= ec_dec_bit_logp(d, bits);
      consumed = ec_tell(d);
      tf_changed |= diff;
    }
    s->tf_change[i] = diff;
    bits = transient ? 4 : 5;
  }
  const int8_t* tfs = cg_tf_select + (s->duration * 2 + transient) * 4;
  if (tf_select_bit && tfs[0 + tf_changed] != tfs[2 + tf_changed])
    tf_sel = ec_dec_bit_logp(d, 1);
  for (int i = s->startband; i < s->endband; i++)
    s->tf_change[i] = tfs[tf_sel * 2 + s->tf_change[i]];
}

static void celt_alloc_c(CeltC* s, EcDec* d) {
  int CH = s->coded_channels;
  int cap[CELT_MAX_BANDS], boost[CELT_MAX_BANDS], threshold[CELT_MAX_BANDS];
  int bits1[CELT_MAX_BANDS], bits2[CELT_MAX_BANDS],
      trim_offset[CELT_MAX_BANDS];
  int skip_startband = s->startband;
  int dynalloc = 6, alloctrim = 5, extrabits = 0;
  int skip_bit = 0, is_bit = 0, ds_bit = 0;
  int consumed = ec_tell(d);
  s->spread = 2;
  if (consumed + 4 <= s->framebits) s->spread = ec_dec_cdf(d, cg_model_spread);
  for (int i = 0; i < CELT_MAX_BANDS; i++)
    cap[i] = (cg_static_caps[(s->duration * 2 + (CH - 1)) * 21 + i] + 64) *
                 cg_freq_range[i]
             << (CH - 1) << s->duration >> 2;
  int totalbits = s->framebits << 3;
  consumed = ec_tell_frac(d);
  for (int i = s->startband; i < s->endband; i++) {
    int quanta = cg_freq_range[i] << (CH - 1) << s->duration;
    int q8 = quanta << 3;
    int q6 = 6 << 3;
    quanta = q8 < (q6 > quanta ? q6 : quanta) ? q8 : (q6 > quanta ? q6 : quanta);
    boost[i] = 0;
    int band_dynalloc = dynalloc;
    while (consumed + (band_dynalloc << 3) < totalbits && boost[i] < cap[i]) {
      int add = ec_dec_bit_logp(d, band_dynalloc);
      consumed = ec_tell_frac(d);
      if (!add) break;
      boost[i] += quanta;
      totalbits -= quanta;
      band_dynalloc = 1;
    }
    if (boost[i]) dynalloc = dynalloc - 1 > 2 ? dynalloc - 1 : 2;
  }
  if (consumed + (6 << 3) <= totalbits)
    alloctrim = ec_dec_cdf(d, cg_model_alloc_trim);
  totalbits = (s->framebits << 3) - ec_tell_frac(d) - 1;
  s->anticollapse_bit = 0;
  if (s->blocks > 1 && s->duration >= 2 &&
      totalbits >= ((s->duration + 2) << 3))
    s->anticollapse_bit = 1 << 3;
  totalbits -= s->anticollapse_bit;
  if (totalbits >= 1 << 3) skip_bit = 1 << 3;
  totalbits -= skip_bit;
  if (CH == 2) {
    is_bit = cg_log2_frac[s->endband - s->startband];
    if (is_bit <= totalbits) {
      totalbits -= is_bit;
      if (totalbits >= 1 << 3) {
        ds_bit = 1 << 3;
        totalbits -= 1 << 3;
      }
    } else {
      is_bit = 0;
    }
  }
  for (int i = s->startband; i < s->endband; i++) {
    int trim = alloctrim - 5 - s->duration;
    int band = cg_freq_range[i] * (s->endband - i - 1);
    int duration7 = s->duration + 3;
    int scale = duration7 + CH - 1;
    int th = 3 * cg_freq_range[i] << duration7 >> 4;
    threshold[i] = th > (CH << 3) ? th : (CH << 3);
    trim_offset[i] = trim * (band << scale) >> 6;
    if (cg_freq_range[i] << s->duration == 1) trim_offset[i] -= CH << 3;
  }
  int low = 1, high = 11 - 1;
  while (low <= high) {
    int center = (low + high) >> 1;
    int done = 0, total = 0;
    for (int i = s->endband - 1; i >= s->startband; i--) {
      int bandbits = cg_freq_range[i] * cg_static_alloc[center * 21 + i]
                     << (CH - 1) << s->duration >> 2;
      if (bandbits) {
        bandbits += trim_offset[i];
        if (bandbits < 0) bandbits = 0;
      }
      bandbits += boost[i];
      if (bandbits >= threshold[i] || done) {
        done = 1;
        total += bandbits < cap[i] ? bandbits : cap[i];
      } else if (bandbits >= CH << 3) {
        total += CH << 3;
      }
    }
    if (total > totalbits) high = center - 1;
    else low = center + 1;
  }
  high = low--;
  for (int i = s->startband; i < s->endband; i++) {
    int b1 = cg_freq_range[i] * cg_static_alloc[low * 21 + i] << (CH - 1)
             << s->duration >> 2;
    int b2 = high >= 11 ? cap[i]
                        : cg_freq_range[i] * cg_static_alloc[high * 21 + i]
                              << (CH - 1) << s->duration >> 2;
    if (b1) {
      b1 += trim_offset[i];
      if (b1 < 0) b1 = 0;
    }
    if (b2) {
      b2 += trim_offset[i];
      if (b2 < 0) b2 = 0;
    }
    if (low) b1 += boost[i];
    b2 += boost[i];
    if (boost[i]) skip_startband = i;
    b2 -= b1;
    if (b2 < 0) b2 = 0;
    bits1[i] = b1;
    bits2[i] = b2;
  }
  low = 0;
  high = 1 << 6;
  for (int it = 0; it < 6; it++) {
    int center = (low + high) >> 1;
    int done = 0, total = 0;
    for (int j = s->endband - 1; j >= s->startband; j--) {
      int bandbits = bits1[j] + (center * bits2[j] >> 6);
      if (bandbits >= threshold[j] || done) {
        done = 1;
        total += bandbits < cap[j] ? bandbits : cap[j];
      } else if (bandbits >= CH << 3) {
        total += CH << 3;
      }
    }
    if (total > totalbits) high = center;
    else low = center;
  }
  int done = 0, total = 0;
  for (int i = s->endband - 1; i >= s->startband; i--) {
    int bandbits = bits1[i] + (low * bits2[i] >> 6);
    if (bandbits >= threshold[i] || done) done = 1;
    else bandbits = bandbits >= CH << 3 ? CH << 3 : 0;
    bandbits = bandbits < cap[i] ? bandbits : cap[i];
    s->pulses[i] = bandbits;
    total += bandbits;
  }
  for (s->codedbands = s->endband;; s->codedbands--) {
    int j = s->codedbands - 1;
    if (j == skip_startband) {
      totalbits += skip_bit;
      break;
    }
    int remaining = totalbits - total;
    int denom = cg_freq_bands[j + 1] - cg_freq_bands[s->startband];
    int bandbits = remaining / denom;
    remaining -= bandbits * denom;
    int extra = remaining - (cg_freq_bands[j] - cg_freq_bands[s->startband]);
    int allocation =
        s->pulses[j] + bandbits * cg_freq_range[j] + (extra > 0 ? extra : 0);
    int th = threshold[j] > ((CH + 1) << 3) ? threshold[j] : ((CH + 1) << 3);
    if (allocation >= th) {
      if (ec_dec_bit_logp(d, 1)) break;
      total += 1 << 3;
      allocation -= 1 << 3;
    }
    total -= s->pulses[j];
    if (is_bit) {
      total -= is_bit;
      is_bit = cg_log2_frac[j - s->startband];
      total += is_bit;
    }
    s->pulses[j] = allocation >= CH << 3 ? CH << 3 : 0;
    total += s->pulses[j];
  }
  s->intensitystereo = 0;
  s->dualstereo = 0;
  if (is_bit)
    s->intensitystereo =
        s->startband + ec_dec_uint(d, s->codedbands + 1 - s->startband);
  if (s->intensitystereo <= s->startband) totalbits += ds_bit;
  else if (ds_bit) s->dualstereo = ec_dec_bit_logp(d, 1);
  int remaining = totalbits - total;
  int denom = cg_freq_bands[s->codedbands] - cg_freq_bands[s->startband];
  int bandbits = remaining / denom;
  remaining -= bandbits * denom;
  for (int i = s->startband; i < s->codedbands; i++) {
    int bts = remaining < cg_freq_range[i] ? remaining : cg_freq_range[i];
    s->pulses[i] += bts + bandbits * cg_freq_range[i];
    remaining -= bts;
  }
  for (int i = s->startband; i < s->codedbands; i++) {
    int N = cg_freq_range[i] << s->duration;
    int prev_extra = extrabits;
    s->pulses[i] += extrabits;
    if (N > 1) {
      extrabits = s->pulses[i] - cap[i];
      if (extrabits < 0) extrabits = 0;
      s->pulses[i] -= extrabits;
      int dof = N * CH + (CH == 2 && N > 2 && !s->dualstereo &&
                          i < s->intensitystereo);
      int temp = dof * (cg_log_freq_range[i] + (s->duration << 3));
      int offset = (temp >> 1) - dof * 21;
      if (N == 2) offset += dof << 1;
      if (s->pulses[i] + offset < 2 * (dof << 3)) offset += temp >> 2;
      else if (s->pulses[i] + offset < 3 * (dof << 3)) offset += temp >> 3;
      int fine_bits = (s->pulses[i] + offset + (dof << 2)) / (dof << 3);
      int max_bits = (s->pulses[i] >> 3) >> (CH - 1);
      max_bits = max_bits < 8 ? max_bits : 8;
      if (max_bits < 0) max_bits = 0;
      int fb = fine_bits < 0 ? 0 : (fine_bits > max_bits ? max_bits
                                                         : fine_bits);
      s->fine_bits[i] = fb;
      s->fine_priority[i] = fb * (dof << 3) >= s->pulses[i] + offset;
      s->pulses[i] -= fb << (CH - 1) << 3;
    } else {
      extrabits = s->pulses[i] - (CH << 3);
      if (extrabits < 0) extrabits = 0;
      s->pulses[i] -= extrabits;
      s->fine_bits[i] = 0;
      s->fine_priority[i] = 1;
    }
    if (extrabits > 0) {
      int fineextra = extrabits >> (CH + 2);
      int room = 8 - s->fine_bits[i];
      if (fineextra > room) fineextra = room;
      s->fine_bits[i] += fineextra;
      fineextra <<= CH + 2;
      s->fine_priority[i] = fineextra >= extrabits - prev_extra;
      extrabits -= fineextra;
    }
  }
  s->remaining = extrabits;
  for (int i = s->codedbands; i < s->endband; i++) {
    s->fine_bits[i] = s->pulses[i] >> (CH - 1) >> 3;
    s->pulses[i] = 0;
    s->fine_priority[i] = s->fine_bits[i] < 1;
  }
}


// --------------------------------------------------------------- PVQ/bands

static void cwrsi_c(int N, int K, uint64_t i, int* y, uint64_t* norm_out) {
  uint64_t norm = 0;
  int pos = 0;
  while (N > 2) {
    if (K >= N) {
      uint64_t p = pvq_u_at(N, K + 1);
      int sgn = i >= p;
      if (sgn) i -= p;
      int k0 = K;
      uint64_t q = pvq_u_at(N, N);
      if (q > i) {
        K = N;
        do {
          K--;
          p = pvq_u_at(K, N);
        } while (p > i);
      } else {
        p = pvq_u_at(N, K);
        while (p > i) {
          K--;
          p = pvq_u_at(N, K);
        }
      }
      i -= p;
      int val = sgn ? -(k0 - K) : (k0 - K);
      norm += (int64_t)val * val;
      y[pos++] = val;
    } else {
      uint64_t p = pvq_u_at(K, N);
      uint64_t q = pvq_u_at(K + 1, N);
      if (p <= i && i < q) {
        i -= p;
        y[pos++] = 0;
      } else {
        int sgn = i >= q;
        if (sgn) i -= q;
        int k0 = K;
        do {
          K--;
          p = pvq_u_at(K, N);
        } while (p > i);
        i -= p;
        int val = sgn ? -(k0 - K) : (k0 - K);
        norm += (int64_t)val * val;
        y[pos++] = val;
      }
    }
    N--;
  }
  // N == 2
  {
    uint64_t p = 2 * (uint64_t)K + 1;
    int sgn = i >= p;
    if (sgn) i -= p;
    int k0 = K;
    K = (int)((i + 1) / 2);
    if (K) i -= 2 * (uint64_t)K - 1;
    int val = sgn ? -(k0 - K) : (k0 - K);
    norm += (int64_t)val * val;
    y[pos++] = val;
  }
  // N == 1
  {
    int64_t s = -(int64_t)i;
    int val = s == 0 ? K : (int)(((int64_t)K + s) ^ s);
    norm += (int64_t)val * val;
    y[pos] = val;
  }
  *norm_out = norm;
}

static void exp_rot1_c(float* X, int len, int stride, float c, float s) {
  for (int i = 0; i < len - stride; i++) {
    float x1 = X[i], x2 = X[i + stride];
    X[i + stride] = c * x2 + s * x1;
    X[i] = c * x1 - s * x2;
  }
  for (int i = len - 2 * stride - 1; i >= 0; i--) {
    float x1 = X[i], x2 = X[i + stride];
    X[i + stride] = c * x2 + s * x1;
    X[i] = c * x1 - s * x2;
  }
}

static void exp_rot_c(float* X, int len, int stride, int K, int spread) {
  if (2 * K >= len || spread == 0) return;
  double gain = (double)len / (len + (20 - 5 * spread) * K);
  double theta = M_PI * gain * gain / 4;
  float c = (float)cos(theta), sn = (float)sin(theta);
  int stride2 = 0;
  if (len >= stride << 3) {
    stride2 = 1;
    while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < len)
      stride2++;
  }
  len /= stride;
  for (int i = 0; i < stride; i++) {
    if (stride2) exp_rot1_c(X + i * len, len, stride2, sn, c);
    exp_rot1_c(X + i * len, len, 1, c, sn);
  }
}

static unsigned collapse_mask_c(const int* y, int N, int B) {
  if (B <= 1) return 1;
  int N0 = N / B;
  unsigned m = 0;
  for (int i = 0; i < B; i++)
    for (int j = 0; j < N0; j++) m |= (unsigned)(y[i * N0 + j] != 0) << i;
  return m;
}

static void renormalize_c(float* X, int N, double gain) {
  double g = 1e-15;
  for (int i = 0; i < N; i++) g += (double)X[i] * X[i];
  float k = (float)(gain / sqrt(g));
  for (int i = 0; i < N; i++) X[i] *= k;
}

static void haar1_c(float* X, int N0, int stride) {
  N0 >>= 1;
  const float r = (float)0.7071067811865476;
  for (int i = 0; i < stride; i++)
    for (int j = 0; j < N0; j++) {
      float x0 = X[stride * (2 * j) + i];
      float x1 = X[stride * (2 * j + 1) + i];
      X[stride * (2 * j) + i] = (x0 + x1) * r;
      X[stride * (2 * j + 1) + i] = (x0 - x1) * r;
    }
}

static void interleave_had_c(float* X, int N0, int stride, int hadamard,
                             float* tmp) {
  if (hadamard) {
    const uint8_t* ordery = cg_hadamard + stride - 2;
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < N0; j++) tmp[j * stride + i] = X[ordery[i] * N0 + j];
  } else {
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < N0; j++) tmp[j * stride + i] = X[i * N0 + j];
  }
  memcpy(X, tmp, sizeof(float) * N0 * stride);
}

static void deinterleave_had_c(float* X, int N0, int stride, int hadamard,
                               float* tmp) {
  if (hadamard) {
    const uint8_t* ordery = cg_hadamard + stride - 2;
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < N0; j++) tmp[ordery[i] * N0 + j] = X[j * stride + i];
  } else {
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < N0; j++) tmp[i * N0 + j] = X[j * stride + i];
  }
  memcpy(X, tmp, sizeof(float) * N0 * stride);
}

static int compute_qn_c(int N, int b, int offset, int pulse_cap,
                        int dualstereo) {
  int N2 = 2 * N - 1;
  if (dualstereo && N == 2) N2--;
  int qb = b - pulse_cap - (4 << 3);
  int t = (b + N2 * offset) / N2;
  if (t < qb) qb = t;
  if (qb > 8 << 3) qb = 8 << 3;
  if (qb < 4) return 1;
  return ((cg_qn_exp2[qb & 7] >> (14 - (qb >> 3))) + 1) >> 1 << 1;
}

static int bits2pulses_c(int offs, int bits) {
  int low = 0, high = cg_cache_bits[offs];
  bits--;
  for (int i = 0; i < 6; i++) {
    int center = (low + high + 1) >> 1;
    if (cg_cache_bits[offs + center] >= bits) high = center;
    else low = center;
  }
  int lowv = low == 0 ? -1 : cg_cache_bits[offs + low];
  return (bits - lowv <= cg_cache_bits[offs + high] - bits) ? low : high;
}

static inline int pulses2bits_c(int offs, int pulses) {
  return pulses == 0 ? 0 : cg_cache_bits[offs + pulses] + 1;
}

static unsigned alg_unquant_c(CeltC* s, EcDec* d, float* X, int N, int K,
                              int spread, int blocks, double gain) {
  int y[200];
  uint64_t norm;
  uint64_t idx = ec_dec_uint(d, (uint32_t)pvq_v_at(N, K));
  cwrsi_c(N, K, idx, y, &norm);
  float g = (float)(gain / sqrt((double)norm));
  for (int i = 0; i < N; i++) X[i] = (float)((double)y[i] * (double)g);
  exp_rot_c(X, N, blocks, K, s->spread);
  return collapse_mask_c(y, N, blocks);
}

static unsigned celt_band_c(CeltC* s, EcDec* d, int band, float* X, float* Y,
                            int N, int b, int blocks, float* lowband,
                            int duration, float* lowband_out, int level,
                            double gain, float* scratch, unsigned fill) {
  int N0 = N, B0 = blocks;
  int N_B = N / blocks, N_B0 = N_B;
  int dualstereo = Y != NULL;
  int split = dualstereo;
  int time_divide = 0, recombine = 0, inv = 0;
  double mid = 0, side = 0;
  int longblocks = B0 == 1;
  unsigned cm = 0;
  float tmpbuf[200];

  if (N == 1) {
    float* x = X;
    for (int t = 0; t <= dualstereo; t++) {
      int sign = 0;
      if (s->remaining2 >= 1 << 3) {
        sign = (int)ec_dec_bits(d, 1);
        s->remaining2 -= 1 << 3;
        b -= 1 << 3;
      }
      x[0] = sign ? -1.0f : 1.0f;
      x = Y;
    }
    if (lowband_out) lowband_out[0] = X[0];
    return 1;
  }

  if (!dualstereo && level == 0) {
    int tf_change = s->tf_change[band];
    if (tf_change > 0) recombine = tf_change;
    if (lowband &&
        (recombine || ((N_B & 1) == 0 && tf_change < 0) || B0 > 1)) {
      memcpy(scratch, lowband, sizeof(float) * N);
      lowband = scratch;
    }
    for (int k = 0; k < recombine; k++) {
      if (lowband) haar1_c(lowband, N >> k, 1 << k);
      fill = cg_bit_ilv[fill & 0xF] | cg_bit_ilv[fill >> 4] << 2;
    }
    blocks >>= recombine;
    N_B <<= recombine;
    while ((N_B & 1) == 0 && s->tf_change[band] + time_divide < 0) {
      if (lowband) haar1_c(lowband, N_B, blocks);
      fill |= fill << blocks;
      blocks <<= 1;
      N_B >>= 1;
      time_divide++;
    }
    B0 = blocks;
    N_B0 = N_B;
    if (B0 > 1 && lowband)
      deinterleave_had_c(lowband, N_B >> recombine, B0 << recombine,
                         longblocks, tmpbuf);
  }

  int cache_off = cg_cache_index[(duration + 1) * CELT_MAX_BANDS + band];
  if (!dualstereo && duration >= 0 &&
      b > cg_cache_bits[cache_off + cg_cache_bits[cache_off]] + 12 && N > 2) {
    N >>= 1;
    Y = X + N;
    split = 1;
    duration -= 1;
    if (blocks == 1) fill = (fill & 1) | (fill << 1);
    blocks = (blocks + 1) >> 1;
  }

  if (split) {
    int qn, itheta = 0, delta = 0, imid = 0, iside = 0;
    int pulse_cap = cg_log_freq_range[band] + duration * 8;
    int offset = (pulse_cap >> 1) - (dualstereo && N == 2 ? 16 : 4);
    qn = (dualstereo && band >= s->intensitystereo)
             ? 1
             : compute_qn_c(N, b, offset, pulse_cap, dualstereo);
    int tell = ec_tell_frac(d);
    if (qn != 1) {
      if (dualstereo && N > 2) itheta = ec_dec_step(d, qn / 2);
      else if (dualstereo || B0 > 1) itheta = (int)ec_dec_uint(d, qn + 1);
      else itheta = ec_dec_tri(d, qn);
      itheta = (int)((int64_t)itheta * 16384 / qn);
    } else if (dualstereo) {
      inv = (b > 2 << 3 && s->remaining2 > 2 << 3) ? ec_dec_bit_logp(d, 2)
                                                   : 0;
      itheta = 0;
    }
    int qalloc = ec_tell_frac(d) - tell;
    b -= qalloc;
    unsigned orig_fill = fill;
    if (itheta == 0) {
      imid = 32767;
      iside = 0;
      fill &= (1u << blocks) - 1;
      delta = -16384;
    } else if (itheta == 16384) {
      imid = 0;
      iside = 32767;
      fill &= ((1u << blocks) - 1) << blocks;
      delta = 16384;
    } else {
      imid = celt_cos_c(itheta);
      iside = celt_cos_c(16384 - itheta);
      delta = (((N - 1) << 7) * celt_log2tan_c(iside, imid) + 16384) >> 15;
    }
    mid = imid / 32768.0;
    side = iside / 32768.0;

    if (N == 2 && dualstereo) {
      int mbits = b;
      int sbits = (itheta != 0 && itheta != 16384) ? 1 << 3 : 0;
      mbits -= sbits;
      int c = itheta > 8192;
      s->remaining2 -= qalloc + sbits;
      float* x2 = c ? Y : X;
      float* y2 = c ? X : Y;
      int sign = 0;
      if (sbits) sign = (int)ec_dec_bits(d, 1);
      sign = 1 - 2 * sign;
      cm = celt_band_c(s, d, band, x2, NULL, N, mbits, blocks, lowband,
                       duration, lowband_out, level, gain, scratch,
                       orig_fill);
      y2[0] = -sign * x2[1];
      y2[1] = sign * x2[0];
      X[0] *= (float)mid;
      X[1] *= (float)mid;
      Y[0] *= (float)side;
      Y[1] *= (float)side;
      float t = X[0];
      X[0] = t - Y[0];
      Y[0] = t + Y[0];
      t = X[1];
      X[1] = t - Y[1];
      Y[1] = t + Y[1];
    } else {
      float* next_lowband2 = NULL;
      float* next_lowband_out1 = NULL;
      int next_level = 0;
      if (B0 > 1 && !dualstereo && (itheta & 0x3FFF)) {
        if (itheta > 8192) delta -= delta >> (4 - duration);
        else {
          int t = delta + (N << 3 >> (5 - duration));
          delta = t < 0 ? t : 0;
        }
      }
      int mbits = (b - delta) / 2;
      if (mbits > b) mbits = b;
      if (mbits < 0) mbits = 0;
      int sbits = b - mbits;
      s->remaining2 -= qalloc;
      if (lowband && !dualstereo) next_lowband2 = lowband + N;
      if (dualstereo) next_lowband_out1 = lowband_out;
      else next_level = level + 1;
      int rebalance = s->remaining2;
      if (mbits >= sbits) {
        cm = celt_band_c(s, d, band, X, NULL, N, mbits, blocks, lowband,
                         duration, next_lowband_out1, next_level,
                         dualstereo ? 1.0 : gain * mid, scratch, fill);
        rebalance = mbits - (rebalance - s->remaining2);
        if (rebalance > 3 << 3 && itheta != 0) sbits += rebalance - (3 << 3);
        cm |= celt_band_c(s, d, band, Y, NULL, N, sbits, blocks,
                          next_lowband2, duration, NULL, next_level,
                          gain * side, NULL, fill >> blocks)
              << ((B0 >> 1) & (dualstereo - 1));
      } else {
        cm = celt_band_c(s, d, band, Y, NULL, N, sbits, blocks,
                         next_lowband2, duration, NULL, next_level,
                         gain * side, NULL, fill >> blocks)
             << ((B0 >> 1) & (dualstereo - 1));
        rebalance = sbits - (rebalance - s->remaining2);
        if (rebalance > 3 << 3 && itheta != 16384)
          mbits += rebalance - (3 << 3);
        cm |= celt_band_c(s, d, band, X, NULL, N, mbits, blocks, lowband,
                          duration, next_lowband_out1, next_level,
                          dualstereo ? 1.0 : gain * mid, scratch, fill);
      }
    }
  } else {
    int q = bits2pulses_c(cache_off, b);
    int curr_bits = pulses2bits_c(cache_off, q);
    s->remaining2 -= curr_bits;
    while (s->remaining2 < 0 && q > 0) {
      s->remaining2 += curr_bits;
      q--;
      curr_bits = pulses2bits_c(cache_off, q);
      s->remaining2 -= curr_bits;
    }
    if (q != 0) {
      int K = q < 8 ? q : (8 + (q & 7)) << ((q >> 3) - 1);
      cm = alg_unquant_c(s, d, X, N, K, s->spread, blocks, gain);
    } else {
      unsigned cm_mask = (1u << blocks) - 1;
      fill &= cm_mask;
      if (!fill) {
        memset(X, 0, sizeof(float) * N);
      } else {
        if (!lowband) {
          for (int j = 0; j < N; j++) {
            uint32_t r = celt_rng_c(s);
            X[j] = (float)((int32_t)r >> 20);
          }
          cm = cm_mask;
        } else {
          for (int j = 0; j < N; j++) {
            uint32_t r = celt_rng_c(s);
            // f32 addition (numpy f32 scalar + weak python float)
            X[j] = lowband[j] + ((r & 0x8000) ? 0.00390625f : -0.00390625f);
          }
          cm = fill;
        }
        renormalize_c(X, N, gain);
      }
    }
  }

  if (dualstereo) {
    if (N != 2) {
      double xp = 0, sidesum = 0;
      for (int i = 0; i < N; i++) {
        xp += (double)X[i] * Y[i];
        sidesum += (double)Y[i] * Y[i];
      }
      xp *= mid;
      double e0 = mid * mid + sidesum - 2 * xp;
      double e1 = mid * mid + sidesum + 2 * xp;
      if (e0 < 6e-4 || e1 < 6e-4) {
        memcpy(Y, X, sizeof(float) * N);
      } else {
        double g0 = 1.0 / sqrt(e0), g1 = 1.0 / sqrt(e1);
        for (int i = 0; i < N; i++) {
          double v0 = mid * X[i];
          double v1 = Y[i];
          X[i] = (float)(g0 * (v0 - v1));
          Y[i] = (float)(g1 * (v0 + v1));
        }
      }
    }
    if (inv)
      for (int j = 0; j < N; j++) Y[j] = -Y[j];
  } else if (level == 0) {
    if (B0 > 1)
      interleave_had_c(X, N_B >> recombine, B0 << recombine, longblocks,
                       tmpbuf);
    N_B = N_B0;
    blocks = B0;
    for (int k = 0; k < time_divide; k++) {
      blocks >>= 1;
      N_B <<= 1;
      cm |= cm >> blocks;
      haar1_c(X, N_B, blocks);
    }
    for (int k = 0; k < recombine; k++) {
      cm = cg_bit_dilv[cm];
      haar1_c(X, N0 >> k, 1 << k);
    }
    blocks <<= recombine;
    if (lowband_out) {
      // float multiply: numpy's weak-scalar promotion computes
      // sqrt(N0) * X in f32 (models/celt.py:927)
      float n = (float)sqrt((double)N0);
      for (int j = 0; j < N0; j++) lowband_out[j] = n * X[j];
    }
    cm &= (1u << blocks) - 1;
  }
  return cm;
}


// ------------------------------------------------------------ frame driver

static void celt_fine_c(CeltC* s, EcDec* d) {
  for (int i = s->startband; i < s->endband; i++) {
    if (!s->fine_bits[i]) continue;
    for (int ch = 0; ch < s->coded_channels; ch++) {
      int q2 = (int)ec_dec_bits(d, s->fine_bits[i]);
      double offset =
          (q2 + 0.5) * (1 << (14 - s->fine_bits[i])) / 16384.0 - 0.5;
      s->energy[ch * 21 + i] += offset;
    }
  }
}

static void celt_final_c(CeltC* s, EcDec* d, int bits_left) {
  for (int priority = 0; priority < 2; priority++) {
    for (int i = s->startband;
         i < s->endband && bits_left >= s->coded_channels; i++) {
      if (s->fine_priority[i] != priority || s->fine_bits[i] >= 8) continue;
      for (int ch = 0; ch < s->coded_channels; ch++) {
        int q2 = (int)ec_dec_bits(d, 1);
        double offset =
            (q2 - 0.5) * (1 << (14 - s->fine_bits[i] - 1)) / 16384.0;
        s->energy[ch * 21 + i] += offset;
        bits_left--;
      }
    }
  }
}

static void celt_bands_c(CeltC* s, EcDec* d) {
  float scratch[8 * 22];
  float norm_store[2 * 8 * 100];  // stack: keeps the stage reentrant
  float* norm = norm_store;
  float* norm2 = norm_store + 8 * 100;
  int totalbits = (s->framebits << 3) - s->anticollapse_bit;
  int update_lowband = 1;
  int lowband_offset = 0;
  memset(s->coeffs, 0, sizeof(float) * 2 * 960);
  for (int i = s->startband; i < s->endband; i++) {
    int band_offset = cg_freq_bands[i] << s->duration;
    int band_size = cg_freq_range[i] << s->duration;
    float* X = s->coeffs + band_offset;
    float* Y = s->coded_channels == 2 ? s->coeffs + 960 + band_offset : NULL;
    int consumed = ec_tell_frac(d);
    if (i != s->startband) s->remaining -= consumed;
    s->remaining2 = totalbits - consumed - 1;
    int b = 0;
    if (i <= s->codedbands - 1) {
      int div = s->codedbands - i < 3 ? s->codedbands - i : 3;
      int curr_balance = s->remaining / div;
      int t = s->remaining2 + 1;
      if (s->pulses[i] + curr_balance < t) t = s->pulses[i] + curr_balance;
      b = t < 0 ? 0 : (t > 16383 ? 16383 : t);
    }
    if (cg_freq_bands[i] - cg_freq_range[i] >= cg_freq_bands[s->startband] &&
        (update_lowband || lowband_offset == 0))
      lowband_offset = i;
    int effective_lowband = -1;
    unsigned cm0, cm1;
    if (lowband_offset != 0 &&
        (s->spread != 3 || s->blocks > 1 || s->tf_change[i] < 0)) {
      effective_lowband = cg_freq_bands[s->startband];
      int t = cg_freq_bands[lowband_offset] - cg_freq_range[i];
      if (t > effective_lowband) effective_lowband = t;
      int foldstart = lowband_offset;
      while (cg_freq_bands[--foldstart] > effective_lowband) {}
      int foldend = lowband_offset - 1;
      while (cg_freq_bands[++foldend] < effective_lowband + cg_freq_range[i]) {
      }
      cm0 = cm1 = 0;
      for (int j = foldstart; j < foldend; j++) {
        cm0 |= (unsigned)s->collapse[j];
        cm1 |= (unsigned)s->collapse[(s->coded_channels - 1) * 21 + j];
      }
    } else {
      cm0 = cm1 = (1u << s->blocks) - 1;
    }
    if (s->dualstereo && i == s->intensitystereo) {
      s->dualstereo = 0;
      int j0 = cg_freq_bands[s->startband] << s->duration;
      for (int j = j0; j < band_offset; j++)
        norm[j] = (norm[j] + norm2[j]) / 2;
    }
    if (s->dualstereo) {
      cm0 = celt_band_c(
          s, d, i, X, NULL, band_size, b / 2, s->blocks,
          effective_lowband != -1 ? norm + (effective_lowband << s->duration)
                                  : NULL,
          s->duration, norm + band_offset, 0, 1.0, scratch, cm0);
      cm1 = celt_band_c(
          s, d, i, Y, NULL, band_size, b / 2, s->blocks,
          effective_lowband != -1 ? norm2 + (effective_lowband << s->duration)
                                  : NULL,
          s->duration, norm2 + band_offset, 0, 1.0, scratch, cm1);
    } else {
      cm0 = celt_band_c(
          s, d, i, X, Y, band_size, b, s->blocks,
          effective_lowband != -1 ? norm + (effective_lowband << s->duration)
                                  : NULL,
          s->duration, norm + band_offset, 0, 1.0, scratch, cm0 | cm1);
      cm1 = cm0;
    }
    s->collapse[i] = (int32_t)(cm0 & 0xFF);
    s->collapse[(s->coded_channels - 1) * 21 + i] = (int32_t)(cm1 & 0xFF);
    s->remaining += s->pulses[i] + consumed;
    update_lowband = b > band_size << 3;
  }
}

static void celt_anticollapse_c(CeltC* s, int ch, float* X) {
  for (int i = s->startband; i < s->endband; i++) {
    int renorm = 0;
    int depth = (1 + s->pulses[i]) / (cg_freq_range[i] << s->duration);
    double thresh = exp2(-1.0 - 0.125 * depth);
    double sqrt_1 = 1.0 / sqrt((double)(cg_freq_range[i] << s->duration));
    int off = cg_freq_bands[i] << s->duration;
    double prev0 = s->prev_energy[ch * 42 + 0 * 21 + i];
    double prev1 = s->prev_energy[ch * 42 + 1 * 21 + i];
    if (s->coded_channels == 1) {
      double p0b = s->prev_energy[1 * 42 + 0 * 21 + i];
      double p1b = s->prev_energy[1 * 42 + 1 * 21 + i];
      if (p0b > prev0) prev0 = p0b;
      if (p1b > prev1) prev1 = p1b;
    }
    double mn = prev0 < prev1 ? prev0 : prev1;
    double ediff = s->energy[ch * 21 + i] - mn;
    if (ediff < 0) ediff = 0;
    double r = exp2(1 - ediff);
    if (s->duration == 3) r *= 1.4142135623730951;
    if (r > thresh) r = thresh;
    r *= sqrt_1;
    for (int k = 0; k < 1 << s->duration; k++) {
      if (!(s->collapse[ch * 21 + i] & (1 << k))) {
        for (int j = 0; j < cg_freq_range[i]; j++) {
          uint32_t rr = celt_rng_c(s);
          X[off + (j << s->duration) + k] =
              (rr & 0x8000) ? (float)r : (float)-r;
        }
        renorm = 1;
      }
    }
    if (renorm)
      renormalize_c(X + off, cg_freq_range[i] << s->duration, 1.0);
  }
}

// Full CELT symbol stage for one frame.  State arrays are caller-owned
// (models/celt.py keeps numpy mirrors).  Outputs the denormalized
// spectrum and the integer frame parameters; synthesis stays outside.
// ec_state (in/out, mirrors models/opus.py RangeDecoder so hybrid packets
// can enter mid-stream and continue in Python afterwards):
//   [offs, end_offs, end_window, nend_bits, nbits_total, rng, val, rem,
//    end_bound]
// out_ints: [blocks, silence, transient, pf_period, tell, pf_flag, ...]
// out_doubles: [pf_g0, pf_g1, pf_g2, imdct_scale]
int af_celt_decode_symbols(
    const uint8_t* data, int32_t len, int32_t coded_channels,
    int32_t frame_size, int32_t startband, int32_t endband,
    int32_t output_channels,
    double* energy /*[2*21]*/, double* prev_energy /*[2*2*21]*/,
    int32_t* collapse /*[2*21]*/, uint32_t* seed,
    float* coeffs /*[2*960]*/, int64_t* ec_state /*[9]*/,
    int32_t* out_ints /*[8]*/, double* out_doubles /*[4]*/) {
  CeltC st;
  CeltC* s = &st;
  s->energy = energy;
  s->prev_energy = prev_energy;
  s->collapse = collapse;
  s->seed = seed;
  s->coded_channels = coded_channels;
  s->startband = startband;
  s->endband = endband;
  s->framebits = len * 8;
  s->coeffs = coeffs;
  int duration = 0;
  {
    int t = frame_size / 120;
    while (t > 1) {
      t >>= 1;
      duration++;
    }
  }
  s->duration = duration;
  if (duration > 3 || frame_size != 120 << duration) return -1;
  memset(s->tf_change, 0, sizeof(s->tf_change));
  memset(s->pulses, 0, sizeof(s->pulses));
  memset(s->fine_bits, 0, sizeof(s->fine_bits));
  memset(s->fine_priority, 0, sizeof(s->fine_priority));
  for (int i = 0; i < 42; i++) collapse[i] = 0;

  EcDec dec;
  dec.buf = data;
  dec.storage = len;
  dec.offs = (int32_t)ec_state[0];
  dec.end_offs = (int32_t)ec_state[1];
  dec.end_window = (uint32_t)ec_state[2];
  dec.nend_bits = (int32_t)ec_state[3];
  dec.nbits_total = (int32_t)ec_state[4];
  dec.rng = (uint32_t)ec_state[5];
  dec.val = (uint32_t)ec_state[6];
  dec.rem = (uint32_t)ec_state[7];
  dec.end_bound = (int32_t)ec_state[8];
  dec.ext = 0;
  EcDec* d = &dec;

  int silence = 0;
  int consumed = ec_tell(d);
  if (consumed >= s->framebits) silence = 1;
  else if (consumed == 1) silence = ec_dec_bit_logp(d, 15);
  if (silence) {
    consumed = s->framebits;
    d->nbits_total += s->framebits - ec_tell(d);
  }

  // postfilter parse
  double pf_g[3] = {0, 0, 0};
  int pf_period = 0;
  int pf_flag = 0;
  if (s->startband == 0 && consumed + 16 <= s->framebits) {
    if (ec_dec_bit_logp(d, 1)) {
      pf_flag = 1;
      int octave = (int)ec_dec_uint(d, 6);
      pf_period = (16 << octave) + (int)ec_dec_bits(d, 4 + octave) - 1;
      double gain = 0.09375 * ((int)ec_dec_bits(d, 3) + 1);
      int tapset = (ec_tell(d) + 2 <= s->framebits)
                       ? ec_dec_cdf(d, cg_model_tapset)
                       : 0;
      if (pf_period < 15) pf_period = 15;
      pf_g[0] = gain * cg_pf_taps[tapset * 3];
      pf_g[1] = gain * cg_pf_taps[tapset * 3 + 1];
      pf_g[2] = gain * cg_pf_taps[tapset * 3 + 2];
    }
    consumed = ec_tell(d);
  }

  int transient = 0;
  if (s->duration != 0 && consumed + 3 <= s->framebits)
    transient = ec_dec_bit_logp(d, 3);
  s->blocks = transient ? 1 << s->duration : 1;
  s->blocksize = frame_size / s->blocks;

  if (coded_channels == 1)
    for (int i = 0; i < CELT_MAX_BANDS; i++)
      if (energy[21 + i] > energy[i]) energy[i] = energy[21 + i];

  celt_coarse_c(s, d);
  celt_tf_c(s, d, transient);
  celt_alloc_c(s, d);
  celt_fine_c(s, d);
  celt_bands_c(s, d);

  int anticollapse = 0;
  if (s->anticollapse_bit) anticollapse = (int)ec_dec_bits(d, 1);
  celt_final_c(s, d, s->framebits - ec_tell(d));

  for (int ch = 0; ch < coded_channels; ch++) {
    if (anticollapse) celt_anticollapse_c(s, ch, coeffs + ch * 960);
    for (int i = s->startband; i < s->endband; i++) {
      int off = cg_freq_bands[i] << s->duration;
      int n = cg_freq_range[i] << s->duration;
      float norm = (float)exp2(energy[ch * 21 + i] + cg_mean_energy[i]);
      for (int j = 0; j < n; j++) coeffs[ch * 960 + off + j] *= norm;
    }
  }

  double imdct_scale = 1.0;
  if (output_channels < coded_channels) {
    for (int j = 0; j < frame_size; j++) coeffs[j] += coeffs[960 + j];
    imdct_scale = 0.5;
  } else if (output_channels > coded_channels) {
    memcpy(coeffs + 960, coeffs, sizeof(float) * frame_size);
  }

  if (silence) {
    for (int i = 0; i < 42; i++) energy[i] = -28.0;
    memset(coeffs, 0, sizeof(float) * 2 * 960);
  }

  // state roll
  if (coded_channels == 1)
    for (int i = 0; i < 21; i++) energy[21 + i] = energy[i];
  for (int ch = 0; ch < 2; ch++) {
    if (!transient) {
      for (int i = 0; i < 21; i++) {
        prev_energy[ch * 42 + 21 + i] = prev_energy[ch * 42 + i];
        prev_energy[ch * 42 + i] = energy[ch * 21 + i];
      }
    } else {
      for (int i = 0; i < 21; i++)
        if (energy[ch * 21 + i] < prev_energy[ch * 42 + i])
          prev_energy[ch * 42 + i] = energy[ch * 21 + i];
    }
    for (int i = 0; i < s->startband; i++) {
      prev_energy[ch * 42 + i] = -28.0;
      energy[ch * 21 + i] = 0.0;
    }
    for (int i = s->endband; i < 21; i++) {
      prev_energy[ch * 42 + i] = -28.0;
      energy[ch * 21 + i] = 0.0;
    }
  }
  *seed = d->rng;
  ec_state[0] = d->offs;
  ec_state[1] = d->end_offs;
  ec_state[2] = d->end_window;
  ec_state[3] = d->nend_bits;
  ec_state[4] = d->nbits_total;
  ec_state[5] = d->rng;
  ec_state[6] = d->val;
  ec_state[7] = d->rem;
  ec_state[8] = d->end_bound;
  out_ints[0] = s->blocks;
  out_ints[1] = silence;
  out_ints[2] = transient;
  out_ints[3] = pf_period;
  out_ints[4] = ec_tell(d);
  out_ints[5] = pf_flag;
  out_doubles[0] = pf_g[0];
  out_doubles[1] = pf_g[1];
  out_doubles[2] = pf_g[2];
  out_doubles[3] = imdct_scale;
  return 0;
}


// --------------------------------------------------- CELT synthesis tail
// Mirrors models/celt.py _postfilter_transition/_postfilter_body/
// _postfilter/_finish_channel (comb postfilter is genuinely IIR when the
// period is under the span: rolling registers, double precision).

static void pf_transition_c(double* d, int pos, int T0, int T1,
                            const double* g_old, const double* g_new) {
  if (g_new[0] == 0.0 && g_old[0] == 0.0) return;
  double g00 = g_old[0], g01 = g_old[1], g02 = g_old[2];
  double g10 = g_new[0], g11 = g_new[1], g12 = g_new[2];
  double x1 = d[pos - T1 + 1], x2 = d[pos - T1], x3 = d[pos - T1 - 1],
         x4 = d[pos - T1 - 2];
  for (int i = 0; i < 120; i++) {
    double w = cg_window[i] * cg_window[i];
    double x0 = d[pos + i - T1 + 2];
    d[pos + i] += (1.0 - w) * g00 * d[pos + i - T0] +
                  (1.0 - w) * g01 * (d[pos + i - T0 - 1] + d[pos + i - T0 + 1]) +
                  (1.0 - w) * g02 * (d[pos + i - T0 - 2] + d[pos + i - T0 + 2]) +
                  w * g10 * x2 + w * g11 * (x1 + x3) + w * g12 * (x0 + x4);
    x4 = x3;
    x3 = x2;
    x2 = x1;
    x1 = x0;
  }
}

static void pf_body_c(double* d, int pos, int T, const double* g,
                      int length) {
  if (g[0] == 0.0 || length <= 0) return;
  double g0 = g[0], g1 = g[1], g2 = g[2];
  double x4 = d[pos - T - 2], x3 = d[pos - T - 1], x2 = d[pos - T],
         x1 = d[pos - T + 1];
  for (int i = 0; i < length; i++) {
    double x0 = d[pos + i - T + 2];
    d[pos + i] += g0 * x2 + g1 * (x1 + x3) + g2 * (x0 + x4);
    x4 = x3;
    x3 = x2;
    x2 = x1;
    x1 = x0;
  }
}

// periods: [old, cur, new] (old/cur updated); gains: [old0..2, cur0..2,
// new0..2] (old/cur updated); deemph: carried pre-multiplied memory.
int af_celt_finish_channel(double* buf /*[2048]*/, int32_t frame_size,
                           int32_t* periods /*[3]*/, double* gains /*[9]*/,
                           double* deemph /*[1]*/, float* out) {
  int length = frame_size;
  pf_transition_c(buf, 1024, periods[0], periods[1], gains, gains + 3);
  periods[0] = periods[1];
  memcpy(gains, gains + 3, 3 * sizeof(double));
  periods[1] = periods[2];
  memcpy(gains + 3, gains + 6, 3 * sizeof(double));
  if (length > 120) {
    pf_transition_c(buf, 1024 + 120, periods[0], periods[1], gains,
                    gains + 3);
    pf_body_c(buf, 1024 + 240, periods[1], gains + 3, length - 240);
    periods[0] = periods[1];
    memcpy(gains, gains + 3, 3 * sizeof(double));
  }
  memmove(buf, buf + length, sizeof(double) * (1024 + 60));
  double m = *deemph;
  for (int j = 0; j < frame_size; j++) {
    double tmp = buf[1024 - frame_size + j] + m;
    m = tmp * 0.85000610;
    out[j] = (float)(tmp / 32768.0);
  }
  *deemph = m;
  return 0;
}


// --------------------------------------------------------- SILK synthesis
// Mirror of models/silk.py _decode_frame lines: re-whitening of past
// output into the residual domain, LTP IIR, and LPC synthesis IIR — all
// SINGLE precision (the reference's own float pipeline: dopus.d:5168-5226
// is FFmpeg's float SILK decoder), same accumulation order as the Python
// fallback (models/silk.py), which mirrors these ops in np.float32.

static inline float silk_clip1(float v) {
  return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}

int af_silk_synth(float* residual /*[290+322]*/, float* out /*[644]*/,
                  float* lpch /*[644]*/, int32_t subframes,
                  int32_t sflength, int32_t order, int32_t voiced,
                  int32_t has_leadin, int32_t interp4,
                  const float* lpc_leadin, const float* lpc_body,
                  const float* sf_gain, const int32_t* sf_pitchlag,
                  const float* sf_ltptaps /*[subframes*5]*/,
                  float ltpscale) {
  for (int i = 0; i < subframes; i++) {
    const float* lpc = (i < 2 && has_leadin) ? lpc_leadin : lpc_body;
    int dst_off = 322 + i * sflength;
    int res_off = 290 + i * sflength;
    int lpc_off = dst_off;
    if (voiced) {
      int out_end;
      float scale;
      if (i < 2 || interp4) {
        out_end = -i * sflength;
        scale = ltpscale;
      } else {
        out_end = -(i - 2) * sflength;
        scale = 1.0f;
      }
      int j0 = -sf_pitchlag[i] - 2;
      for (int j = j0; j < out_end; j++) {
        float total = out[dst_off + j];
        for (int k = 0; k < order; k++)
          total -= lpc[k] * out[dst_off + j - k - 1];
        residual[res_off + j] = silk_clip1(total) * scale / sf_gain[i];
      }
      if (out_end) {
        float rescale = sf_gain[i - 1] / sf_gain[i];
        for (int j = out_end; j < 0; j++) residual[res_off + j] *= rescale;
      }
      const float* taps = sf_ltptaps + i * 5;
      int lag = sf_pitchlag[i];
      for (int j = 0; j < sflength; j++) {
        float total = residual[res_off + j];
        for (int k = 0; k < 5; k++)
          total += taps[k] * residual[res_off + j - lag + 2 - k];
        residual[res_off + j] = total;
      }
    }
    float g = sf_gain[i];
    for (int j = 0; j < sflength; j++) {
      float total = residual[res_off + j] * g;
      for (int k = 1; k <= order; k++)
        total += lpc[k - 1] * lpch[lpc_off + j - k];
      lpch[lpc_off + j] = total;
      out[dst_off + j] = silk_clip1(total);
    }
  }
  return 0;
}


// ------------------------------------------------------- SILK excitation
// Mirror of models/silk.py _decode_excitation: LCG seed, rate level,
// per-shell-block pulse counts, binary-split pulse locations, LSBs,
// signs, and the dither/offset dequantization.  Range-decoder state is
// carried in/out exactly like af_celt_decode_symbols.

static void ec_load(EcDec* d, const uint8_t* buf, int32_t len,
                    const int64_t* st) {
  d->buf = buf;
  d->storage = len;
  d->offs = (int32_t)st[0];
  d->end_offs = (int32_t)st[1];
  d->end_window = (uint32_t)st[2];
  d->nend_bits = (int32_t)st[3];
  d->nbits_total = (int32_t)st[4];
  d->rng = (uint32_t)st[5];
  d->val = (uint32_t)st[6];
  d->rem = (uint32_t)st[7];
  d->end_bound = (int32_t)st[8];
  d->ext = 0;
}

static void ec_store(const EcDec* d, int64_t* st) {
  st[0] = d->offs;
  st[1] = d->end_offs;
  st[2] = d->end_window;
  st[3] = d->nend_bits;
  st[4] = d->nbits_total;
  st[5] = d->rng;
  st[6] = d->val;
  st[7] = d->rem;
  st[8] = d->end_bound;
}

int af_silk_excitation(const uint8_t* data, int32_t len, int64_t* ec_state,
                       int32_t shellblocks, int32_t voiced,
                       int32_t qoffset_high, int32_t active,
                       const uint16_t* lcg_seed /*[5]*/,
                       const uint16_t* exc_rate /*[2*10]*/,
                       const uint16_t* pulse_count /*[11*19]*/,
                       const uint16_t* pulse_loc /*[4*168]*/,
                       const uint16_t* exc_lsb /*[3]*/,
                       const uint16_t* exc_sign /*[3*2*7*3]*/,
                       const int32_t* quant_offset /*[2*2]*/,
                       float* out /*[shellblocks*16]*/) {
  EcDec dec;
  ec_load(&dec, data, len, ec_state);
  EcDec* d = &dec;

  uint32_t seed = (uint32_t)ec_dec_cdf(d, lcg_seed);
  int ratelevel = ec_dec_cdf(d, exc_rate + voiced * 10);
  int pulses[20], lsbs[20];
  for (int i = 0; i < shellblocks; i++) {
    lsbs[i] = 0;
    pulses[i] = ec_dec_cdf(d, pulse_count + ratelevel * 19);
    if (pulses[i] == 17) {
      while (pulses[i] == 17) {
        lsbs[i]++;
        if (lsbs[i] == 10) break;
        pulses[i] = ec_dec_cdf(d, pulse_count + 9 * 19);
      }
      if (lsbs[i] == 10) pulses[i] = ec_dec_cdf(d, pulse_count + 10 * 19);
    }
  }

  int exc[20 * 16];
  memset(exc, 0, sizeof(int) * shellblocks * 16);
  for (int i = 0; i < shellblocks; i++) {
    if (pulses[i] == 0) continue;
    int base = 16 * i;
    // binary split tree: count_children(model, total)
    int lvl1[2], lvl2[2], lvl3[2], lvl4[2];
#define COUNT_CHILDREN(model, total, dst)                               \
    do {                                                                \
      if (total) {                                                      \
        int off_ = (((total) - 1 + 5) * ((total) - 1)) >> 1;            \
        int c0_ = ec_dec_cdf(d, pulse_loc + (model) * 168 + off_);      \
        (dst)[0] = c0_;                                                 \
        (dst)[1] = (total) - c0_;                                       \
      } else {                                                          \
        (dst)[0] = 0;                                                   \
        (dst)[1] = 0;                                                   \
      }                                                                 \
    } while (0)
    COUNT_CHILDREN(0, pulses[i], lvl1);
    int pos = 0;
    for (int b = 0; b < 2; b++) {
      COUNT_CHILDREN(1, lvl1[b], lvl2);
      for (int c = 0; c < 2; c++) {
        COUNT_CHILDREN(2, lvl2[c], lvl3);
        for (int e = 0; e < 2; e++) {
          COUNT_CHILDREN(3, lvl3[e], lvl4);
          exc[base + pos] = lvl4[0];
          exc[base + pos + 1] = lvl4[1];
          pos += 2;
        }
      }
    }
#undef COUNT_CHILDREN
  }

  int total16 = shellblocks << 4;
  for (int i = 0; i < total16; i++)
    for (int k = 0; k < lsbs[i >> 4]; k++)
      exc[i] = (exc[i] << 1) | ec_dec_cdf(d, exc_lsb);

  for (int i = 0; i < total16; i++) {
    if (exc[i] != 0) {
      int pc = pulses[i >> 4] < 6 ? pulses[i >> 4] : 6;
      int sign = ec_dec_cdf(
          d, exc_sign + (((active + voiced) * 2 + qoffset_high) * 7 + pc) * 3);
      if (sign == 0) exc[i] = -exc[i];
    }
  }

  int qoff = quant_offset[voiced * 2 + qoffset_high];
  for (int i = 0; i < total16; i++) {
    int value = exc[i];
    int ev = value * 256 | qoff;
    if (value < 0) ev += 20;
    else if (value > 0) ev -= 20;
    seed = 196314165u * seed + 907633515u;
    if (seed & 0x80000000u) ev = -ev;
    seed = seed + (uint32_t)value;
    // |ev| < 2^24, so ev/2^23 is exact in single precision
    out[i] = (float)(ev / 8388608.0);
  }
  ec_store(d, ec_state);
  return 0;
}


// ------------------------------------------------------------ SILK LSF
// Mirror of models/silk.py _lsf2lpc / _lsp2poly / _is_lpc_stable: exact
// fixed-point NLSF(Q15) -> LPC conversion with bandwidth expansion and
// the inverse-Levinson stability loop.  All intermediates fit int64.

static inline int64_t silk_round_mull(int64_t a, int64_t b, int s) {
  return ((a * b >> (s - 1)) + 1) >> 1;
}

static inline int64_t silk_mulh(int64_t a, int64_t b) {
  return (a * b) >> 32;
}

static inline int silk_ilog64(int64_t x) {
  int n = 0;
  while (x) {
    n++;
    x >>= 1;
  }
  return n;
}

static void silk_lsp2poly(const int64_t* lsp, int half_order, int off,
                          int64_t* pol) {
  pol[0] = 65536;
  pol[1] = -lsp[off];
  for (int i = 1; i < half_order; i++) {
    pol[i + 1] =
        pol[i - 1] * 2 - silk_round_mull(lsp[off + 2 * i], pol[i], 16);
    for (int j = i; j > 1; j--)
      pol[j] += pol[j - 2] - silk_round_mull(lsp[off + 2 * i], pol[j - 1],
                                             16);
    pol[1] -= lsp[off + 2 * i];
  }
}

static int silk_lpc_stable(const int64_t* lpc, int order) {
  int64_t DC_resp = 0;
  int64_t row[16], prevrow[16];
  for (int k = 0; k < order; k++) {
    DC_resp += lpc[k];
    row[k] = lpc[k] * 4096;
  }
  if (DC_resp >= 4096) return 0;
  int64_t totalinvgain = (int64_t)1 << 30;
  int k = order - 1;
  for (;;) {
    if (row[k] > 16773022 || row[k] < -16773022) return 0;
    int64_t rc = -(row[k] * 128);
    int64_t gaindiv = ((int64_t)1 << 30) - silk_mulh(rc, rc);
    totalinvgain = silk_mulh(totalinvgain, gaindiv) << 2;
    if (k == 0) return totalinvgain >= 107374;
    int fbits = silk_ilog64(gaindiv);
    int64_t gain = (((int64_t)1 << 29) - 1) / (gaindiv >> (fbits + 1 - 16));
    int64_t error =
        ((int64_t)1 << 29) - ((gaindiv << (15 + 16 - fbits)) * gain >> 16);
    gain = (gain << 16) + (error * gain >> 13);
    memcpy(prevrow, row, sizeof(int64_t) * order);
    for (int j = 0; j < k; j++) {
      int64_t x =
          prevrow[j] - silk_round_mull(prevrow[k - j - 1], rc, 31);
      row[j] = silk_round_mull(x, gain, fbits);
    }
    k--;
  }
}

int af_silk_lsf2lpc(const int32_t* nlsf, int32_t order,
                    const int32_t* cosine /*[129]*/,
                    const uint8_t* ordering /*[order]*/,
                    double* out /*[order]*/) {
  int64_t lsp[16], p[9], q[9], lpc32[16], lpc[16];
  for (int k = 0; k < order; k++) {
    int index = nlsf[k] >> 8;
    int offset = nlsf[k] & 255;
    int64_t v = (int64_t)cosine[index] * 256;
    v += (int64_t)(cosine[index + 1] - cosine[index]) * offset;
    lsp[ordering[k]] = (v + 4) >> 3;
  }
  silk_lsp2poly(lsp, order >> 1, 0, p);
  silk_lsp2poly(lsp, order >> 1, 1, q);
  for (int k = 0; k < order >> 1; k++) {
    lpc32[k] = -p[k + 1] - p[k] - q[k + 1] + q[k];
    lpc32[order - k - 1] = -p[k + 1] - p[k] + q[k + 1] - q[k];
  }

  int i;
  for (i = 0; i < 10; i++) {
    int64_t maxabs = 0;
    int kk = 0;
    for (int j = 0; j < order; j++) {
      int64_t x = lpc32[j] < 0 ? -lpc32[j] : lpc32[j];
      if (x > maxabs) {
        maxabs = x;
        kk = j;
      }
    }
    maxabs = (maxabs + 16) >> 5;
    if (maxabs > 32767) {
      if (maxabs > 163838) maxabs = 163838;
      int64_t chirp_base =
          65470 - (((maxabs - 32767) << 14) / ((maxabs * (kk + 1)) >> 2));
      int64_t chirp = chirp_base;
      for (int k = 0; k < order; k++) {
        lpc32[k] = silk_round_mull(lpc32[k], chirp, 16);
        chirp = (chirp_base * chirp + 32768) >> 16;
      }
    } else {
      break;
    }
  }
  if (i == 10) {
    for (int k = 0; k < order; k++) {
      int64_t x = (lpc32[k] + 16) >> 5;
      lpc[k] = x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
      lpc32[k] = lpc[k] << 5;
    }
  } else {
    for (int k = 0; k < order; k++) lpc[k] = (lpc32[k] + 16) >> 5;
  }

  for (int it = 1; it <= 16 && !silk_lpc_stable(lpc, order); it++) {
    int64_t chirp_base = 65536 - ((int64_t)1 << it);
    int64_t chirp = chirp_base;
    for (int k = 0; k < order; k++) {
      lpc32[k] = silk_round_mull(lpc32[k], chirp, 16);
      lpc[k] = (lpc32[k] + 16) >> 5;
      chirp = (chirp_base * chirp + 32768) >> 16;
    }
  }
  for (int k = 0; k < order; k++) out[k] = (double)lpc[k] / 4096.0;
  return 0;
}


// ---------------------------------------------------------------- Ogg CRC
// CRC-32 (poly 0x04C11DB7, unreflected, init 0) used by Ogg page headers
// (RFC 3533); mirrors io/ogg.py:ogg_crc for fast page verification.

uint32_t af_ogg_crc(const uint8_t* p, int64_t n, uint32_t crc) {
  static uint32_t tab[256];
  static int init_done = 0;
  if (!init_done) {
    for (int i = 0; i < 256; i++) {
      uint32_t r = (uint32_t)i << 24;
      for (int k = 0; k < 8; k++)
        r = (r << 1) ^ ((r & 0x80000000u) ? 0x04C11DB7u : 0);
      tab[i] = r;
    }
    init_done = 1;
  }
  for (int64_t i = 0; i < n; i++)
    crc = (crc << 8) ^ tab[((crc >> 24) & 0xFF) ^ p[i]];
  return crc;
}


// -------------------------------------------------------- Vorbis residue
// Mirror of models/vorbis.py Codebook.decode + _residue_passes.  Python
// packs every codebook into a flat bank (two-level bit-reversed LUTs +
// concatenated VQ vectors); this routine then decodes a whole residue
// block per call.  The bit reader is LSB-first over the packet
// (io/bits.py:BitReaderLSB): peek is zero-padded past the end, a skip
// past the end aborts the residue with partial data standing (the
// reference treats end-of-packet mid-residue the same way).

typedef struct {
  const uint8_t* buf;
  int64_t nbits;
  int64_t pos;
} BitLSB;

static inline uint32_t lsb_peek24(const BitLSB* b) {
  int64_t first = b->pos >> 3;
  int64_t nbytes = (b->nbits + 7) >> 3;
  uint64_t word = 0;
  for (int64_t i = 0; i < 4 && first + i < nbytes; i++)
    word |= (uint64_t)b->buf[first + i] << (8 * i);
  return (uint32_t)((word >> (b->pos & 7)) & 0xFFFFFF);
}

#define CB_UNUSED INT32_MIN

// returns entry >= 0, or -1 on end-of-packet / invalid codeword
static inline int32_t cb_decode(BitLSB* b, const int32_t* lut1_book,
                                const int32_t* subs_off,
                                const uint8_t* subs_ext,
                                const int32_t* subs_flat) {
  uint32_t peek = lsb_peek24(b);
  int32_t e = lut1_book[peek & 0x3FF];
  if (e == CB_UNUSED) return -1;
  if (e < 0) {
    int gs = -e - 1;
    int ext = subs_ext[gs];
    e = subs_flat[subs_off[gs] + ((peek >> 10) & ((1u << ext) - 1))];
    if (e == CB_UNUSED) return -1;
  }
  int ln = e >> 24;
  if (b->pos + ln > b->nbits) return -1;
  b->pos += ln;
  return e & 0xFFFFFF;
}

int af_vorbis_residue(
    const uint8_t* buf, int64_t nbits, int64_t* bitpos_io,
    const int32_t* lut1 /*[n_books << 10]*/, const int32_t* subs_off,
    const uint8_t* subs_ext, const int32_t* subs_flat,
    const float* vec_flat, const int64_t* vec_off /*[n_books]*/,
    const int32_t* cb_dims /*[n_books]*/,
    int32_t classbook, int32_t classifications,
    const int32_t* books /*[classifications * 8]*/,
    int32_t rtype, int32_t part_size, int64_t begin,
    int32_t eff_ch, int32_t partitions_to_read,
    const uint8_t* do_not_decode /*[eff_ch]*/,
    float* target_base, int64_t row_stride,
    int64_t* classifs, int64_t classif_stride) {
  BitLSB b = {buf, nbits, *bitpos_io};
  const int32_t* cls_lut1 = lut1 + ((int64_t)classbook << 10);
  int cw = cb_dims[classbook];
  int rc = 0;
  for (int pass_ = 0; pass_ < 8 && !rc; pass_++) {
    int pcount = 0;
    while (pcount < partitions_to_read && !rc) {
      if (pass_ == 0) {
        for (int j = 0; j < eff_ch; j++) {
          if (rtype != 2 && do_not_decode[j]) continue;
          int32_t temp = cb_decode(&b, cls_lut1, subs_off, subs_ext,
                                   subs_flat);
          if (temp < 0) { rc = 1; goto done; }
          for (int i = cw - 1; i >= 0; i--) {
            classifs[j * classif_stride + pcount + i] =
                temp % classifications;
            temp /= classifications;
          }
        }
      }
      for (int i = 0; i < cw; i++) {
        if (pcount >= partitions_to_read) break;
        int64_t offset = begin + (int64_t)pcount * part_size;
        for (int j = 0; j < eff_ch; j++) {
          if (rtype != 2 && do_not_decode[j]) continue;
          int vqclass = (int)classifs[j * classif_stride + pcount];
          int32_t book = books[vqclass * 8 + pass_];
          if (book < 0) continue;
          if (vec_off[book] < 0) { rc = 1; goto done; }
          const float* vecs = vec_flat + vec_off[book];
          const int32_t* bl = lut1 + ((int64_t)book << 10);
          int dims = cb_dims[book];
          float* target = target_base + j * row_stride;
          if (rtype == 0) {
            int step = part_size / dims;
            for (int k = 0; k < step; k++) {
              int32_t entry = cb_decode(&b, bl, subs_off, subs_ext,
                                        subs_flat);
              if (entry < 0) { rc = 1; goto done; }
              const float* v = vecs + (int64_t)entry * dims;
              for (int m = 0; m < dims; m++)
                target[offset + k + (int64_t)m * step] += v[m];
            }
          } else {
            for (int k = 0; k < part_size; k += dims) {
              int32_t entry = cb_decode(&b, bl, subs_off, subs_ext,
                                        subs_flat);
              if (entry < 0) { rc = 1; goto done; }
              const float* v = vecs + (int64_t)entry * dims;
              for (int m = 0; m < dims; m++) target[offset + k + m] += v[m];
            }
          }
        }
        pcount++;
      }
    }
  }
done:
  *bitpos_io = b.pos;
  return rc;
}

// LSB-first read of n <= 24 bits; fails (returns 0, position unchanged)
// past the end — matching BitReaderLSB.read's check-before-advance.
static inline int lsb_read(BitLSB* b, int n, uint32_t* out) {
  if (b->pos + n > b->nbits) return 0;
  *out = lsb_peek24(b) & ((n >= 24) ? 0xFFFFFFu : ((1u << n) - 1));
  b->pos += n;
  return 1;
}

static inline int32_t floor1_render_point(int32_t x0, int32_t y0, int32_t x1,
                                          int32_t y1, int32_t X) {
  int32_t dy = y1 - y0;
  int32_t adx = x1 - x0;
  int32_t ady = dy < 0 ? -dy : dy;
  int32_t off = (int32_t)(((int64_t)ady * (X - x0)) / adx);
  return dy < 0 ? y0 - off : y0 + off;
}

// Closed-form Bresenham segment (models/vorbis.py _render_line parity:
// y(x0+k) = y0 + base*k +/- floor(k*ady'/adx), clipped to [0, 255]).
static void floor1_render_line(int32_t x0, int32_t y0, int32_t x1, int32_t y1,
                               float* curve, const float* inv_db) {
  int32_t dy = y1 - y0;
  int32_t adx = x1 - x0;
  if (adx <= 0) return;
  int32_t base = dy / adx;  // C division truncates toward zero, as py does
  int32_t abase = base < 0 ? -base : base;
  int32_t ady = (dy < 0 ? -dy : dy) - abase * adx;
  for (int32_t k = 0; k < adx; k++) {
    int32_t step = (int32_t)(((int64_t)k * ady) / adx);
    int32_t y = y0 + base * k + (dy >= 0 ? step : -step);
    if (y < 0) y = 0;
    if (y > 255) y = 255;
    curve[x0 + k] = inv_db[y];
  }
}

// Decode the floor1 curves of ONE audio packet's channels (the per-channel
// loop in VorbisModel._packet_entropy) against the packed codebook bank.
// fblob/foff: VorbisFloorBank (native.py) — per-floor config blob of
//   [partitions, multiplier, n_pts,
//    partition_class[31], class_dims[16], class_subclasses[16],
//    class_masterbooks[16], subclass_books[16*8],
//    xlist[n_pts], sorted_idx[n_pts], neighbors[2*n_pts] (lo,hi at 2*i)].
// ch_floor[c]: floor config index per channel; curves: [ch, n2] f32 out;
// used[c]: 1 iff the channel's curve decoded fully (Python parity: the
// channel where end-of-packet / an invalid codeword hits stays unused and
// the remaining channels are not attempted).
int af_vorbis_floor1(
    const uint8_t* buf, int64_t nbits, int64_t* bitpos_io,
    const int32_t* lut1, const int32_t* subs_off, const uint8_t* subs_ext,
    const int32_t* subs_flat,
    const int32_t* fblob, const int64_t* foff,
    const int32_t* ch_floor, int32_t ch, int64_t n2,
    const float* inv_db /*[256]*/, float* curves, uint8_t* used) {
  static const int32_t kRanges[4] = {256, 128, 86, 64};
  BitLSB b = {buf, nbits, *bitpos_io};
  for (int c = 0; c < ch; c++) used[c] = 0;
  for (int c = 0; c < ch; c++) {
    uint32_t present;
    if (!lsb_read(&b, 1, &present)) goto abort;
    if (!present) continue;  // curve unused for this channel
    {
      const int32_t* blob = fblob + foff[ch_floor[c]];
      int32_t P = blob[0], mult = blob[1], npts = blob[2];
      const int32_t* pclass = blob + 3;
      const int32_t* cdims = pclass + 31;
      const int32_t* csubs = cdims + 16;
      const int32_t* cmast = csubs + 16;
      const int32_t* sbooks = cmast + 16;  // [16 * 8]
      const int32_t* xlist = sbooks + 128;
      const int32_t* sorted_idx = xlist + npts;
      const int32_t* neigh = sorted_idx + npts;  // (lo, hi) at 2*i, i >= 2
      int32_t ranges = kRanges[mult - 1];
      int ybits = 0;
      for (int32_t v = ranges - 1; v > 0; v >>= 1) ybits++;
      int32_t y[290];
      uint32_t y0, y1;
      if (!lsb_read(&b, ybits, &y0) || !lsb_read(&b, ybits, &y1)) goto abort;
      y[0] = (int32_t)y0;
      y[1] = (int32_t)y1;
      int yc = 2;
      for (int p = 0; p < P; p++) {
        int32_t cls = pclass[p];
        int32_t cdim = cdims[cls], cbits = csubs[cls];
        int32_t cs = (1 << cbits) - 1;
        int32_t cval = 0;
        if (cbits) {
          cval = cb_decode(&b, lut1 + ((int64_t)cmast[cls] << 10), subs_off,
                           subs_ext, subs_flat);
          if (cval < 0) goto abort;
        }
        for (int d = 0; d < cdim; d++) {
          int32_t book = sbooks[cls * 8 + (cval & cs)];
          cval >>= cbits;
          if (book >= 0) {
            int32_t v = cb_decode(&b, lut1 + ((int64_t)book << 10), subs_off,
                                  subs_ext, subs_flat);
            if (v < 0) goto abort;
            y[yc++] = v;
          } else {
            y[yc++] = 0;
          }
        }
      }
      // amplitude synthesis (spec section 7.2.4)
      int32_t fy[290];
      uint8_t st[290];
      fy[0] = y[0];
      fy[1] = y[1];
      st[0] = st[1] = 1;
      for (int i = 2; i < npts; i++) {
        int32_t lo = neigh[2 * i], hi = neigh[2 * i + 1];
        int32_t pred = floor1_render_point(xlist[lo], fy[lo], xlist[hi],
                                           fy[hi], xlist[i]);
        int32_t val = y[i];
        int32_t hroom = ranges - pred, lroom = pred;
        int32_t room = 2 * (hroom < lroom ? hroom : lroom);
        if (val) {
          st[lo] = st[hi] = st[i] = 1;
          if (val >= room) {
            fy[i] = hroom > lroom ? val - lroom + pred
                                  : pred - val + hroom - 1;
          } else {
            fy[i] = (val & 1) ? pred - ((val + 1) >> 1) : pred + (val >> 1);
          }
        } else {
          st[i] = 0;
          fy[i] = pred;
        }
      }
      // curve synthesis: lines between step2 posts in sorted-x order
      float* curve = curves + (int64_t)c * n2;
      for (int64_t k = 0; k < n2; k++) curve[k] = 0.0f;
      int32_t lx = 0, ly = fy[sorted_idx[0]] * mult;
      for (int k = 1; k < npts; k++) {
        int32_t idx = sorted_idx[k];
        if (!st[idx]) continue;
        int32_t hx = xlist[idx], hy = fy[idx] * mult;
        if (lx < n2)
          floor1_render_line(lx, ly, hx < n2 ? hx : (int32_t)n2, hy, curve,
                             inv_db);
        lx = hx;
        ly = hy;
      }
      if (lx < n2) {
        int32_t idx = ly < 255 ? ly : 255;
        if (idx < 0) idx += 256;  // Python table[min(ly,255)] wraparound
        float v = inv_db[idx];
        for (int64_t x = lx; x < n2; x++) curve[x] = v;
      }
      used[c] = 1;
    }
  }
abort:
  *bitpos_io = b.pos;
  return 0;
}

// Multi-lane driver for the packed-wire FLAC window parse: one FFI
// crossing Rice-decodes a whole lane chunk into [B, W*ch, stride]
// batch rows (the per-lane ctypes call + per-lane numpy output
// allocation cost more than the C Rice walk at batch 512).  stride
// must equal every processed lane's max_block (af_flac_parse_frame
// uses max_block as both the validation bound and the channel-row
// stride); the scheduler falls back to the per-lane path when a
// group mixes streaminfo max_block values.  cur_bits is read-only
// here — the Python post-pass advances it, because the sample-count
// cap may take fewer frames than were parsed.
int af_flac_parse_window_multi(
    const int32_t* lanes, int32_t n_lanes,
    const uint64_t* data_ptrs, const int64_t* data_lens,
    const int64_t* cur_bits /* [B] */, const int32_t* bps_in /* [B] */,
    int32_t expect_channels, int32_t stride, int32_t W,
    int32_t* residual /* [B, W*ch, stride] */,
    int32_t* coeffs /* [B, W*ch, 32] */,
    int32_t* order_o, int32_t* shift_o, int32_t* wasted_o,
    int32_t* bps_o /* each [B, W*ch] */,
    int64_t* meta /* [B, W, 4] */, int32_t* n_out /* [B] */) {
  int32_t ch = expect_channels;
  for (int32_t i = 0; i < n_lanes; i++) {
    int64_t bi = lanes[i];
    const uint8_t* data = (const uint8_t*)(uintptr_t)data_ptrs[bi];
    int64_t nbytes = data_lens[bi];
    int64_t bits = cur_bits[bi];
    int64_t rbase = bi * (int64_t)W * ch;
    int f = 0;
    for (; f < W; f++) {
      if (bits >= nbytes * 8 - 15) break;
      int64_t row = rbase + (int64_t)f * ch;
      int rc = af_flac_parse_frame(
          data, nbytes, bits, bps_in[bi], ch, stride,
          residual + row * stride, coeffs + row * 32,
          order_o + row, shift_o + row, wasted_o + row, bps_o + row,
          meta + (bi * W + f) * 4);
      if (rc != 0) break;
      bits = meta[(bi * W + f) * 4 + 3];
    }
    n_out[bi] = f;
  }
  return 0;
}

// Frame-pool assembly for the device-Rice wire mode: copy every raw
// frame to a BLK-aligned pool offset and byteswap the pool to the
// kernel's big-endian u32 word order, in one C pass.  Replaces a
// per-frame numpy frombuffer+copy loop plus a whole-pool astype
// byteswap copy (~0.7 s/rep at batch 512).
int af_flac_build_pool(const uint64_t* ptrs, const int64_t* offs,
                       const int64_t* sizes, int32_t n_frames,
                       int32_t blk_b, uint8_t* pool /* zeroed */,
                       int64_t pool_bytes, int64_t* base_bits) {
  int64_t cur = 0;  // block cursor
  for (int32_t i = 0; i < n_frames; i++) {
    int64_t nb = sizes[i];
    int64_t room = pool_bytes - cur * blk_b;
    if (nb > room) nb = room;
    if (nb < 0) nb = 0;
    memcpy(pool + cur * blk_b, (const uint8_t*)(uintptr_t)ptrs[i] + offs[i],
           (size_t)nb);
    base_bits[i] = cur * blk_b * 8;
    cur += (nb + blk_b - 1) / blk_b;
  }
  uint32_t* w = (uint32_t*)pool;
  int64_t nw = cur * blk_b / 4;
  for (int64_t k = 0; k < nw; k++) w[k] = __builtin_bswap32(w[k]);
  return 0;
}

// Multi-lane driver for the FLAC frame sync index (device-Rice wire
// mode's whole host stage): one FFI crossing indexes a lane chunk.
// Per-lane outputs are rows of [B, max_frames] batch arrays; the lane's
// persistent sync state is row bi of states [B,3] (expected frame
// number, sample-numbering flag, resume byte — the resume byte doubles
// as the scan start offset, exactly like the per-lane call sites).
int af_flac_sync_index_multi(
    const int32_t* lanes, int32_t n_lanes,
    const uint64_t* data_ptrs /* [B] */, const int64_t* data_lens,
    const int32_t* bps_in /* [B] streaminfo bps */, int32_t expect_ch,
    int32_t max_block, int32_t max_frames,
    int64_t* states /* [B,3] */,
    int64_t* offs /* [B,W] */, int64_t* data_bits /* [B,W] */,
    int32_t* bs /* [B,W] */, int32_t* ca /* [B,W] */,
    int32_t* bps_out /* [B,W] */, int32_t* n_out /* [B] */) {
  for (int32_t i = 0; i < n_lanes; i++) {
    int64_t bi = lanes[i];
    int64_t w = bi * max_frames;
    n_out[bi] = af_flac_sync_index(
        (const uint8_t*)(uintptr_t)data_ptrs[bi], data_lens[bi],
        states[bi * 3 + 2], bps_in[bi], expect_ch, max_block, max_frames,
        states + bi * 3, offs + w, data_bits + w, bs + w, ca + w,
        bps_out + w);
  }
  return 0;
}

// Multi-lane driver for the packed MP3 window parse: ONE FFI crossing
// parses a whole lane chunk.  A per-lane ctypes call pays Python-side
// marshalling (pointer casts, keepalives, arg tuples) per lane and window,
// which at batch 1024 cost more than the C parse itself.  Every per-lane tensor is a row of a batch-
// contiguous array; per-lane pointers derive from base + lane * stride,
// so the FFI surface is a fixed set of base pointers no matter how many
// lanes the chunk holds.  Strides are in ELEMENTS of the pointee type.
int af_mp3_parse_window_packed_multi(
    const int32_t* lanes, int32_t n_lanes,
    const uint64_t* data_ptrs /* [B] */, const int64_t* data_lens,
    int64_t* offs /* [B] in/out */, const uint8_t* hdr0s /* [B,4] */,
    int32_t max_frames, const int32_t* ffbytes /* [B] */,
    uint8_t* rb_all /* [B,511] */, int32_t* rl_all /* [B] */,
    int32_t* ist_all /* [B,80] */,
    uint32_t* bits, int64_t bits_stride,
    int32_t* max_words_all /* [B] out */,
    int32_t* meta, int64_t meta_stride,
    int16_t* scfq, int64_t scfq_stride,
    int16_t* ist_out, int64_t ist_out_stride /* 0 => no ist plane */,
    int32_t* aa, int64_t aa_stride,
    int32_t* wt, int64_t wt_stride,
    uint8_t* flags, int64_t flags_stride,
    int32_t* n_out /* [B] out */) {
  for (int32_t i = 0; i < n_lanes; i++) {
    int64_t bi = lanes[i];
    max_words_all[bi] = 0;
    n_out[bi] = af_mp3_parse_window_packed(
        (const uint8_t*)(uintptr_t)data_ptrs[bi], data_lens[bi], offs[bi],
        hdr0s + bi * 4, max_frames, ffbytes[bi], rb_all + bi * 511,
        rl_all + bi, ist_all + bi * 80, bits + bi * bits_stride,
        max_words_all + bi, meta + bi * meta_stride,
        scfq + bi * scfq_stride,
        ist_out_stride ? ist_out + bi * ist_out_stride : nullptr,
        aa + bi * aa_stride, wt + bi * wt_stride,
        flags + bi * flags_stride, offs + bi);
  }
  return 0;
}

}  // extern "C"
