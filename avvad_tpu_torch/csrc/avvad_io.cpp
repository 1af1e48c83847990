// avvad_io: native host-IO core for the avvad_tpu data pipeline.
//
// The framework's host-side hot path during training/eval is WAV decode +
// peak normalization + (for label building) frame-energy VAD over millions
// of utterance reads. The reference does all of this through Python
// (torchaudio/librosa); here the inner loops are C++ behind a minimal C ABI
// consumed via ctypes (no pybind11 dependency).
//
// Also LZF decompression for the port's HDF5 reader (avvad_tpu_torch/hdf5.py),
// and zstd decompression and CRC-32C for its Orbax checkpoint reader
// (avvad_tpu_torch/orbax_io.py).
//
// Formats: RIFF/WAVE with PCM 8/16/32-bit and IEEE float32, arbitrary
// channel count (channel 0 is returned, matching the pipeline's
// convention). Scaling matches avvad_tpu.processing.audio_io: int16/32 map
// to [-1, 1) by 1/2^(bits-1); uint8 is offset binary.
//
// Build: make -C native   (produces libavvad_io.so; loaded lazily by
// avvad_tpu.native with a pure-Python fallback when absent).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <memory>
#include <vector>

extern "C" {

// Error codes (negative returns)
enum {
  AVVAD_ERR_OPEN = -1,
  AVVAD_ERR_FORMAT = -2,
  AVVAD_ERR_TRUNCATED = -3,
  AVVAD_ERR_TOOSMALL = -4,
  AVVAD_ERR_BADARG = -5,
};

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits_per_sample;
  int32_t audio_format;  // 1 = PCM, 3 = IEEE float
  int64_t n_frames;      // samples per channel
  int64_t data_offset;   // byte offset of sample data
  int64_t data_bytes;
};

static int parse_wav_header(FILE* f, WavInfo* info) {
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return AVVAD_ERR_TRUNCATED;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return AVVAD_ERR_FORMAT;

  bool have_fmt = false;
  info->data_offset = -1;
  for (;;) {
    uint8_t chunk[8];
    if (fread(chunk, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      uint8_t fmt[16];
      if (size < 16 || fread(fmt, 1, 16, f) != 16) return AVVAD_ERR_TRUNCATED;
      uint16_t audio_format, channels, block_align, bits;
      uint32_t sample_rate;
      memcpy(&audio_format, fmt + 0, 2);
      memcpy(&channels, fmt + 2, 2);
      memcpy(&sample_rate, fmt + 4, 4);
      memcpy(&block_align, fmt + 12, 2);
      memcpy(&bits, fmt + 14, 2);
      // WAVE_FORMAT_EXTENSIBLE (0xFFFE) carries the real format in the
      // extension; treat it as PCM (NTCD-TIMIT is plain PCM anyway).
      info->audio_format = (audio_format == 0xFFFE) ? 1 : audio_format;
      info->channels = channels;
      info->sample_rate = (int32_t)sample_rate;
      info->bits_per_sample = bits;
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      fseek(f, size + (size & 1), SEEK_CUR);
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  if (!have_fmt || info->data_offset < 0) return AVVAD_ERR_FORMAT;
  int bytes_per_frame = info->channels * (info->bits_per_sample / 8);
  if (bytes_per_frame <= 0) return AVVAD_ERR_FORMAT;
  info->n_frames = info->data_bytes / bytes_per_frame;
  return 0;
}

// Fill (sr, channels, n_frames) for a wav file; returns 0 or an error code.
int wav_info(const char* path, int32_t* sample_rate, int32_t* channels,
             int64_t* n_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return AVVAD_ERR_OPEN;
  WavInfo info;
  int rc = parse_wav_header(f, &info);
  fclose(f);
  if (rc != 0) return rc;
  *sample_rate = info.sample_rate;
  *channels = info.channels;
  *n_frames = info.n_frames;
  return 0;
}

// Decode channel 0 into out[0..max_samples) as float32 in [-1, 1].
// Returns the number of samples written, or a negative error code.
int64_t wav_read_f32(const char* path, float* out, int64_t max_samples,
                     int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return AVVAD_ERR_OPEN;
  WavInfo info;
  int rc = parse_wav_header(f, &info);
  if (rc != 0) { fclose(f); return rc; }
  if (info.n_frames > max_samples) { fclose(f); return AVVAD_ERR_TOOSMALL; }
  *sample_rate = info.sample_rate;

  fseek(f, (long)info.data_offset, SEEK_SET);
  std::vector<uint8_t> raw((size_t)info.data_bytes);
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return AVVAD_ERR_TRUNCATED;
  }
  fclose(f);

  const int ch = info.channels;
  const int64_t n = info.n_frames;
  switch (info.bits_per_sample) {
    case 8: {  // unsigned, offset binary
      const uint8_t* p = raw.data();
      for (int64_t i = 0; i < n; ++i)
        out[i] = ((float)p[i * ch] - 128.0f) / 128.0f;
      break;
    }
    case 16: {
      const int16_t* p = (const int16_t*)raw.data();
      const float s = 1.0f / 32768.0f;
      for (int64_t i = 0; i < n; ++i) out[i] = (float)p[i * ch] * s;
      break;
    }
    case 32: {
      if (info.audio_format == 3) {  // IEEE float
        const float* p = (const float*)raw.data();
        for (int64_t i = 0; i < n; ++i) out[i] = p[i * ch];
      } else {
        const int32_t* p = (const int32_t*)raw.data();
        const double s = 1.0 / 2147483648.0;
        for (int64_t i = 0; i < n; ++i) out[i] = (float)(p[i * ch] * s);
      }
      break;
    }
    default:
      return AVVAD_ERR_FORMAT;
  }
  return n;
}

// In-place x /= max(|x|). No-op on all-zero input.
void peak_normalize(float* x, int64_t n) {
  float peak = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    float a = std::fabs(x[i]);
    if (a > peak) peak = a;
  }
  if (peak > 0.0f) {
    const float inv = 1.0f / peak;
    for (int64_t i = 0; i < n; ++i) x[i] *= inv;
  }
}

// Frame-energy VAD over an (optionally end-padded) signal:
//   vad[t] = sum(x[t*hop : t*hop+nfft]^2) > 10^threshold * min_frame_power
// Matches avvad_tpu.processing.targets.clean_speech_VAD (pad decision is
// the caller's: pass pad_end = hop to append that many zeros).
// Returns the number of frames written, or a negative error code.
int64_t frame_energy_vad(const float* x, int64_t n, int32_t nfft, int32_t hop,
                         int32_t pad_end, double threshold_log10, float* out,
                         int64_t max_frames) {
  if (nfft <= 0 || hop <= 0 || n + pad_end < nfft) return AVVAD_ERR_BADARG;
  const int64_t total = n + pad_end;
  const int64_t n_frames = 1 + (total - nfft) / hop;
  if (n_frames > max_frames) return AVVAD_ERR_TOOSMALL;

  std::vector<double> power((size_t)n_frames);
  double min_power = 1e300;
  for (int64_t t = 0; t < n_frames; ++t) {
    const int64_t s = t * hop;
    double acc = 0.0;
    const int64_t lim = (s + nfft <= n) ? nfft : (n > s ? n - s : 0);
    const float* p = x + s;
    for (int64_t k = 0; k < lim; ++k) acc += (double)p[k] * (double)p[k];
    power[(size_t)t] = acc;
    if (acc < min_power) min_power = acc;
  }
  const double thr = std::pow(10.0, threshold_log10) * min_power;
  for (int64_t t = 0; t < n_frames; ++t)
    out[t] = power[(size_t)t] > thr ? 1.0f : 0.0f;
  return n_frames;
}

// LZF decompression (liblzf's format, HDF5 filter 32000 as h5py writes
// it): a control byte c < 32 starts a literal run of c + 1 bytes; otherwise
// a back reference of length (c >> 5) + 2 (a length of 7 takes one more
// byte), to offset ((c & 0x1f) << 8) + next byte + 1 behind the output
// position, copied byte by byte (it may overlap its own output). Returns
// the number of bytes written, -1 on corrupt input, -2 if the output would
// exceed out_len.
int64_t lzf_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                       int64_t out_len) {
  const uint8_t* ip = in;
  const uint8_t* const in_end = in + in_len;
  uint8_t* op = out;
  uint8_t* const out_end = out + out_len;
  while (ip < in_end) {
    uint32_t ctrl = *ip++;
    if (ctrl < (1u << 5)) {
      ctrl++;
      if (op + ctrl > out_end) return -2;
      if (ip + ctrl > in_end) return -1;
      std::memcpy(op, ip, ctrl);
      op += ctrl;
      ip += ctrl;
    } else {
      uint32_t len = ctrl >> 5;
      const uint8_t* ref = op - ((ctrl & 0x1f) << 8) - 1;
      if (ip >= in_end) return -1;
      if (len == 7) {
        len += *ip++;
        if (ip >= in_end) return -1;
      }
      ref -= *ip++;
      len += 2;
      if (op + len > out_end) return -2;
      if (ref < out) return -1;
      for (uint32_t k = 0; k < len; ++k) *op++ = *ref++;
    }
  }
  return op - out;
}

// ---------------------------------------------------------------------------
// Zstandard decompression (RFC 8878) and CRC-32C for the JAX package's Orbax
// checkpoints (avvad_tpu_torch/orbax_io.py): their zarr chunks and OCDBT
// nodes are zstd frames, and OCDBT files end in a CRC-32C.
//
// Covered: any number of frames (and skippable frames) in one buffer;
// frames with or without the content size and the content checksum
// (XXH64, checked); raw, RLE and compressed blocks; literals raw, RLE and
// Huffman-coded in one or four streams, the tree given directly or as
// FSE-coded weights, or repeated from the previous block ("treeless");
// sequences with predefined, RLE, FSE-coded and repeated tables and the
// three repeat offsets. Dictionaries are not supported (a frame that names
// one is refused). The whole output is one contiguous buffer, so matches
// reach back as far as the frame's own output, whatever its window size.
// Every read is bounds-checked: a malformed frame returns a negative code
// (zstd_error_name says which), never reads outside the input and never
// writes past out_cap.
extern "C++" {
namespace zstd_dec {

enum {
  OK = 0, E_TRUNCATED = -1, E_MAGIC = -2, E_HEADER = -3, E_DICT = -4,
  E_BLOCK = -5, E_LITERALS = -6, E_HUFFMAN = -7, E_FSE = -8,
  E_SEQUENCES = -9, E_OFFSET = -10, E_CHECKSUM = -11, E_SIZE = -12,
  E_DST_SMALL = -13,
};

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint32_t kMagic = 0xFD2FB528u;

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}
inline uint64_t le64(const uint8_t* p) {
  return (uint64_t)le32(p) | ((uint64_t)le32(p + 4) << 32);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// --- XXH64 -----------------------------------------------------------------
constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}
uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* const end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t)le32(p) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t)*p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --- bit readers -------------------------------------------------------------
// Backward stream (Huffman, FSE): the last byte's highest set bit marks the
// end; bits are read from there towards the first byte. pos = unread bits;
// a read below bit 0 yields zeros and leaves pos < 0 ("overflow").
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;
  int init(const uint8_t* src, size_t len) {
    if (len == 0 || src[len - 1] == 0) return E_TRUNCATED;
    p = src;
    n = len;
    pos = (int64_t)len * 8 - 8 + highbit(src[len - 1]);
    return OK;
  }
  uint64_t extract(int64_t lo, int k) const {  // bits [lo, lo + k), k <= 56
    if (k == 0) return 0;
    if (lo < 0) {
      int64_t hi = lo + k;
      return hi <= 0 ? 0 : extract(0, (int)hi) << (-lo);
    }
    size_t byte = (size_t)(lo >> 3);
    uint64_t v = 0;
    if (n - byte >= 8)
      std::memcpy(&v, p + byte, 8);
    else
      std::memcpy(&v, p + byte, n - byte);
    return (v >> (lo & 7)) & ((1ull << k) - 1);
  }
  uint64_t read(int k) {
    pos -= k;
    return extract(pos, k);
  }
  uint64_t peek(int k) const { return extract(pos - k, k); }
};

// Forward stream, least significant bit first (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint32_t peek(int k) const {  // zeros past the end
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      size_t b = pos + i;
      if ((b >> 3) < n) v |= (uint32_t)((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
};

// --- FSE -----------------------------------------------------------------------
struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};
struct FseTable {
  int log = -1;  // -1: none yet
  std::vector<FseEntry> t;
};

int build_fse(FseTable& T, const int16_t* norm, int max_sym, int log) {
  const int size = 1 << log;
  T.log = log;
  T.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(max_sym + 1);
  int high = size - 1;
  for (int s = 0; s <= max_sym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) return E_FSE;
      T.t[high--].symbol = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint32_t)norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= max_sym; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      T.t[pos].symbol = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) return E_FSE;
  for (int u = 0; u < size; ++u) {
    uint32_t ns = next[T.t[u].symbol]++;
    if (ns == 0) return E_FSE;
    int nb = log - highbit(ns);
    if (nb < 0) return E_FSE;
    T.t[u].nbits = (uint8_t)nb;
    T.t[u].base = (uint16_t)((ns << nb) - size);
  }
  return OK;
}

void rle_fse(FseTable& T, int symbol) {
  T.log = 0;
  T.t.assign(1, FseEntry{(uint16_t)symbol, 0, 0});
}

// An FSE table description -> bytes read (or an error), the normalised
// counts in norm[0..*max_sym] and the accuracy log.
int64_t read_fse_dist(const uint8_t* src, size_t n, int max_symbol, int max_log,
                      int16_t* norm, int* log_out, int* max_sym_out) {
  if (n == 0) return E_TRUNCATED;
  FwdBits br{src, n};
  const size_t total = n * 8;
  const int log = (int)br.peek(4) + 5;
  br.pos = 4;
  if (log > max_log) return E_FSE;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_symbol) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = br.peek(2);
        br.pos += 2;
        n0 += (int)r;
        if (br.pos > total) return E_FSE;
        if (r != 3) break;
      }
      if (n0 > max_symbol) return E_FSE;
      while (sym < n0) norm[sym++] = 0;
    }
    const int maxv = 2 * threshold - 1 - remaining;
    const uint32_t v = br.peek(nbits);
    int count;
    if ((int)(v & (threshold - 1)) < maxv) {
      count = (int)(v & (threshold - 1));
      br.pos += nbits - 1;
    } else {
      count = (int)(v & (2 * threshold - 1));
      if (count >= threshold) count -= maxv;
      br.pos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    prev0 = count == 0;
    if (remaining < 1 || br.pos > total) return E_FSE;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || br.pos > total) return E_FSE;
  *log_out = log;
  *max_sym_out = sym - 1;
  return (int64_t)((br.pos + 7) / 8);
}

// --- Huffman ---------------------------------------------------------------
struct HufEntry {
  uint8_t symbol;
  uint8_t nbits;
};
struct HufTable {
  int log = 0;  // 0: none yet
  std::vector<HufEntry> t;
};

// A Huffman tree description -> bytes read (or an error).
int64_t read_huf_table(HufTable& H, const uint8_t* src, size_t n) {
  if (n == 0) return E_TRUNCATED;
  uint8_t w[256];
  int nw = 0;
  size_t used;
  const uint8_t hb = src[0];
  if (hb >= 128) {  // weights given directly, 4 bits each
    nw = hb - 127;
    const size_t nb = (size_t)(nw + 1) / 2;
    if (1 + nb > n) return E_TRUNCATED;
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
    used = 1 + nb;
  } else {  // FSE-coded weights: two interleaved states
    const size_t cs = hb;
    if (cs == 0 || 1 + cs > n) return E_HUFFMAN;
    int16_t norm[256];
    int log, max_sym;
    int64_t d = read_fse_dist(src + 1, cs, 255, 6, norm, &log, &max_sym);
    if (d < 0) return E_HUFFMAN;
    FseTable T;
    if (build_fse(T, norm, max_sym, log) != OK) return E_HUFFMAN;
    BackBits br;
    if (br.init(src + 1 + d, cs - (size_t)d) != OK) return E_HUFFMAN;
    uint32_t s1 = (uint32_t)br.read(log), s2 = (uint32_t)br.read(log);
    if (br.pos < 0) return E_HUFFMAN;
    for (;;) {
      if (nw > 254) return E_HUFFMAN;
      w[nw++] = (uint8_t)T.t[s1].symbol;
      s1 = T.t[s1].base + (uint32_t)br.read(T.t[s1].nbits);
      if (br.pos < 0) {
        if (nw > 254) return E_HUFFMAN;
        w[nw++] = (uint8_t)T.t[s2].symbol;
        break;
      }
      if (nw > 254) return E_HUFFMAN;
      w[nw++] = (uint8_t)T.t[s2].symbol;
      s2 = T.t[s2].base + (uint32_t)br.read(T.t[s2].nbits);
      if (br.pos < 0) {
        if (nw > 254) return E_HUFFMAN;
        w[nw++] = (uint8_t)T.t[s1].symbol;
        break;
      }
    }
    used = 1 + cs;
  }
  // the last symbol's weight is implied: it fills the total to a power of 2
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) return E_HUFFMAN;
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) return E_HUFFMAN;
  const int maxbits = highbit(total) + 1;
  const uint32_t rest = (1u << maxbits) - total;
  if (maxbits > 11 || (rest & (rest - 1))) return E_HUFFMAN;
  w[nw] = (uint8_t)(highbit(rest) + 1);
  const int nsym = nw + 1;
  uint32_t count[13] = {0}, start[13] = {0};
  for (int s = 0; s < nsym; ++s) count[w[s]]++;
  uint32_t next = 0;
  for (int k = 1; k <= maxbits; ++k) {
    start[k] = next;
    next += count[k] << (k - 1);
  }
  if (next != (1u << maxbits)) return E_HUFFMAN;
  H.log = maxbits;
  H.t.assign(1u << maxbits, HufEntry{0, 0});
  for (int s = 0; s < nsym; ++s) {
    if (!w[s]) continue;
    const uint32_t len = 1u << (w[s] - 1);
    for (uint32_t j = 0; j < len; ++j)
      H.t[start[w[s]] + j] = HufEntry{(uint8_t)s, (uint8_t)(maxbits + 1 - w[s])};
    start[w[s]] += len;
  }
  return (int64_t)used;
}

// One Huffman stream being decoded: bits [0, pos) of src unread, out[i..count)
// still to write.
struct HufCursor {
  const uint8_t* src;
  size_t n;
  int64_t pos;
  uint8_t* out;
  size_t count;
  size_t i;
};

int huf_open(HufCursor& c, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackBits br;
  if (br.init(src, n) != OK) return E_HUFFMAN;
  c = HufCursor{src, n, br.pos, out, count, 0};
  return OK;
}

// Four symbols from one 8-byte load, while 57 bits lie below the position
// (4 x 11 bits at most; the load ends within the stream).
inline bool huf_fast(const HufCursor& c) { return c.count - c.i >= 4 && c.pos >= 57 + 44; }

inline void huf_four(const HufTable& H, HufCursor& c) {
  const int64_t base = c.pos - 57;
  uint64_t v;
  std::memcpy(&v, c.src + (base >> 3), 8);
  v >>= base & 7;
  const uint64_t mask = (1ull << H.log) - 1;
  int used = 0;
  for (int k = 0; k < 4; ++k) {
    const HufEntry e = H.t[(v >> (57 - used - H.log)) & mask];
    c.out[c.i++] = e.symbol;
    used += e.nbits;
  }
  c.pos -= used;
}

// The rest of a stream one symbol at a time; every bit must be used.
int huf_finish(const HufTable& H, HufCursor& c) {
  BackBits br;
  br.p = c.src;
  br.n = c.n;
  br.pos = c.pos;
  for (; c.i < c.count; ++c.i) {
    const HufEntry e = H.t[br.peek(H.log)];
    c.out[c.i] = e.symbol;
    br.pos -= e.nbits;
    if (br.pos < 0) return E_HUFFMAN;
  }
  return br.pos == 0 ? OK : E_HUFFMAN;
}

int huf_stream(const HufTable& H, const uint8_t* src, size_t n, uint8_t* out,
               size_t count) {
  HufCursor c;
  if (huf_open(c, src, n, out, count) != OK) return E_HUFFMAN;
  while (huf_fast(c)) huf_four(H, c);
  return huf_finish(H, c);
}

// Four streams, interleaved while each has room: four independent chains
// of table lookups for the core to overlap.
int huf_streams4(const HufTable& H, const uint8_t* const src[4], const size_t n[4],
                 uint8_t* const out[4], const size_t count[4]) {
  HufCursor c[4];
  for (int k = 0; k < 4; ++k)
    if (huf_open(c[k], src[k], n[k], out[k], count[k]) != OK) return E_HUFFMAN;
  while (huf_fast(c[0]) && huf_fast(c[1]) && huf_fast(c[2]) && huf_fast(c[3])) {
    huf_four(H, c[0]);
    huf_four(H, c[1]);
    huf_four(H, c[2]);
    huf_four(H, c[3]);
  }
  for (int k = 0; k < 4; ++k) {
    while (huf_fast(c[k])) huf_four(H, c[k]);
    const int r = huf_finish(H, c[k]);
    if (r != OK) return r;
  }
  return OK;
}

// --- sequences' code tables (RFC 8878, 3.1.1.3.2.1) -------------------------
const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,
                              10, 11, 12,  13,  14,  15,   16,   18,   20,   22,
                              24, 28, 32,  40,  48,  64,   128,  256,  512,  1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
  FseTable ll, ml, of;
  Defaults() {
    build_fse(ll, LL_DEFAULT, 35, 6);
    build_fse(ml, ML_DEFAULT, 52, 6);
    build_fse(of, OF_DEFAULT, 28, 5);
  }
};
const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// --- frames ----------------------------------------------------------------------
struct Frame {  // what one frame's blocks hand on to the next
  HufTable huf;
  FseTable ll, ml, of;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit = std::vector<uint8_t>(kBlockMax);
};

struct Out {
  uint8_t* dst;
  size_t cap;
  size_t pos;
  size_t frame_start;
};

// -> bytes read, the literals in F.lit[0..*nlit)
int64_t decode_literals(Frame& F, const uint8_t* src, size_t n, size_t* nlit) {
  if (n == 0) return E_TRUNCATED;
  const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    size_t hs, rs;
    if (sf == 0 || sf == 2) {
      hs = 1;
      rs = src[0] >> 3;
    } else if (sf == 1) {
      if (n < 2) return E_TRUNCATED;
      hs = 2;
      rs = (src[0] >> 4) + ((size_t)src[1] << 4);
    } else {
      if (n < 3) return E_TRUNCATED;
      hs = 3;
      rs = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)src[2] << 12);
    }
    if (rs > kBlockMax) return E_LITERALS;
    *nlit = rs;
    if (type == 0) {
      if (hs + rs > n) return E_TRUNCATED;
      std::memcpy(F.lit.data(), src + hs, rs);
      return (int64_t)(hs + rs);
    }
    if (hs + 1 > n) return E_TRUNCATED;
    std::memset(F.lit.data(), src[hs], rs);
    return (int64_t)(hs + 1);
  }
  const size_t hs = sf < 2 ? 3 : sf == 2 ? 4 : 5;
  const int bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
  if (n < hs) return E_TRUNCATED;
  uint64_t h = 0;
  for (size_t i = 0; i < hs; ++i) h |= (uint64_t)src[i] << (8 * i);
  const size_t rs = (h >> 4) & ((1u << bits) - 1);
  const size_t cs = (h >> (4 + bits)) & ((1u << bits) - 1);
  if (rs > kBlockMax) return E_LITERALS;
  if (hs + cs > n) return E_TRUNCATED;
  const uint8_t* p = src + hs;
  size_t m = cs;
  if (type == 2) {
    int64_t used = read_huf_table(F.huf, p, m);
    if (used < 0) return used;
    p += used;
    m -= (size_t)used;
  } else if (F.huf.log == 0) {
    return E_HUFFMAN;  // treeless literals with no earlier tree
  }
  *nlit = rs;
  uint8_t* out = F.lit.data();
  if (sf == 0) {
    int r = huf_stream(F.huf, p, m, out, rs);
    if (r != OK) return r;
  } else {
    if (m < 6) return E_TRUNCATED;
    const size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
    if (6 + s1 + s2 + s3 > m) return E_TRUNCATED;
    const size_t s4 = m - 6 - s1 - s2 - s3, seg = (rs + 3) / 4;
    if (3 * seg > rs) return E_LITERALS;
    const size_t sizes[4] = {s1, s2, s3, s4};
    const size_t counts[4] = {seg, seg, seg, rs - 3 * seg};
    const uint8_t* const srcs[4] = {p + 6, p + 6 + s1, p + 6 + s1 + s2, p + 6 + s1 + s2 + s3};
    uint8_t* const outs[4] = {out, out + seg, out + 2 * seg, out + 3 * seg};
    int r = huf_streams4(F.huf, srcs, sizes, outs, counts);
    if (r != OK) return r;
  }
  return (int64_t)(hs + cs);
}

int64_t read_seq_table(FseTable& T, const FseTable& def, int mode, const uint8_t* src,
                       size_t n, int max_symbol, int max_log) {
  switch (mode) {
    case 0:
      T = def;
      return 0;
    case 1:
      if (n < 1) return E_TRUNCATED;
      if (src[0] > max_symbol) return E_SEQUENCES;
      rle_fse(T, src[0]);
      return 1;
    case 2: {
      int16_t norm[64];
      int log, max_sym;
      int64_t d = read_fse_dist(src, n, max_symbol, max_log, norm, &log, &max_sym);
      if (d < 0) return d;
      if (build_fse(T, norm, max_sym, log) != OK) return E_FSE;
      return d;
    }
    default:
      return T.log < 0 ? E_SEQUENCES : 0;  // repeat: the previous block's table
  }
}

int copy_match(Out& o, uint64_t offset, size_t len) {
  if (offset == 0 || offset > o.pos - o.frame_start) return E_OFFSET;
  if (len > o.cap - o.pos) return E_DST_SMALL;
  uint8_t* d = o.dst + o.pos;
  const uint8_t* s = d - offset;
  if (offset >= len) {
    std::memcpy(d, s, len);
  } else {
    for (size_t i = 0; i < len; ++i) d[i] = s[i];
  }
  o.pos += len;
  return OK;
}

int decode_block(Frame& F, const uint8_t* src, size_t n, Out& o, size_t block_max) {
  const size_t start = o.pos;
  size_t nlit = 0;
  int64_t used = decode_literals(F, src, n, &nlit);
  if (used < 0) return (int)used;
  const uint8_t* p = src + used;
  size_t m = n - (size_t)used;
  if (m < 1) return E_TRUNCATED;
  size_t nseq, hs;
  if (p[0] < 128) {
    nseq = p[0];
    hs = 1;
  } else if (p[0] < 255) {
    if (m < 2) return E_TRUNCATED;
    nseq = ((size_t)(p[0] - 128) << 8) + p[1];
    hs = 2;
  } else {
    if (m < 3) return E_TRUNCATED;
    nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
    hs = 3;
  }
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (m < hs + 1) return E_TRUNCATED;
    const uint8_t modes = p[hs];
    if (modes & 3) return E_SEQUENCES;
    size_t q = hs + 1;
    const Defaults& D = defaults();
    int64_t r = read_seq_table(F.ll, D.ll, modes >> 6, p + q, m - q, 35, 9);
    if (r < 0) return (int)r;
    q += (size_t)r;
    r = read_seq_table(F.of, D.of, (modes >> 4) & 3, p + q, m - q, 31, 8);
    if (r < 0) return (int)r;
    q += (size_t)r;
    r = read_seq_table(F.ml, D.ml, (modes >> 2) & 3, p + q, m - q, 52, 9);
    if (r < 0) return (int)r;
    q += (size_t)r;
    BackBits br;
    if (br.init(p + q, m - q) != OK) return E_SEQUENCES;
    uint32_t lls = (uint32_t)br.read(F.ll.log);
    uint32_t ofs = (uint32_t)br.read(F.of.log);
    uint32_t mls = (uint32_t)br.read(F.ml.log);
    for (size_t i = 0; i < nseq; ++i) {
      const int ofc = F.of.t[ofs].symbol, mlc = F.ml.t[mls].symbol,
                llc = F.ll.t[lls].symbol;
      if (ofc > 31) return E_SEQUENCES;
      const uint64_t ov = (1ull << ofc) + br.read(ofc);
      const size_t ml = ML_BASE[mlc] + (size_t)br.read(ML_BITS[mlc]);
      const size_t ll = LL_BASE[llc] + (size_t)br.read(LL_BITS[llc]);
      uint64_t offset;
      if (ov > 3) {
        offset = ov - 3;
        F.rep[2] = F.rep[1];
        F.rep[1] = F.rep[0];
        F.rep[0] = offset;
      } else {
        const int idx = (int)ov - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = F.rep[0];
        } else {
          offset = idx == 3 ? F.rep[0] - 1 : F.rep[idx];
          if (idx != 1) F.rep[2] = F.rep[1];
          F.rep[1] = F.rep[0];
          F.rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        lls = F.ll.t[lls].base + (uint32_t)br.read(F.ll.t[lls].nbits);
        mls = F.ml.t[mls].base + (uint32_t)br.read(F.ml.t[mls].nbits);
        ofs = F.of.t[ofs].base + (uint32_t)br.read(F.of.t[ofs].nbits);
      }
      if (br.pos < 0) return E_SEQUENCES;
      if (ll > nlit - lit_pos) return E_SEQUENCES;
      if (ll > o.cap - o.pos) return E_DST_SMALL;
      std::memcpy(o.dst + o.pos, F.lit.data() + lit_pos, ll);
      o.pos += ll;
      lit_pos += ll;
      int rc = copy_match(o, offset, ml);
      if (rc != OK) return rc;
      if (o.pos - start > block_max) return E_BLOCK;
    }
    if (br.pos != 0) return E_SEQUENCES;
  } else if (hs != m) {
    return E_SEQUENCES;  // nothing may follow a zero sequence count
  }
  const size_t rest = nlit - lit_pos;
  if (rest > o.cap - o.pos) return E_DST_SMALL;
  std::memcpy(o.dst + o.pos, F.lit.data() + lit_pos, rest);
  o.pos += rest;
  if (o.pos - start > block_max) return E_BLOCK;
  return OK;
}

struct Header {
  size_t size;         // header bytes after the magic
  int64_t content;     // -1: not stated
  uint64_t window;
  bool checksum;
};

int parse_header(const uint8_t* p, size_t n, Header* h) {
  if (n < 1) return E_TRUNCATED;
  const uint8_t fhd = p[0];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) return E_HEADER;  // reserved bit
  h->checksum = (fhd >> 2) & 1;
  size_t q = 1;
  h->window = 0;
  if (!single) {
    if (n < q + 1) return E_TRUNCATED;
    const uint8_t wd = p[q++];
    const int wlog = 10 + (wd >> 3);
    if (wlog > 41) return E_HEADER;
    const uint64_t base = 1ull << wlog;
    h->window = base + (base / 8) * (wd & 7);
  }
  const size_t dict_size[4] = {0, 1, 2, 4};
  const size_t ds = dict_size[dict_flag];
  if (n < q + ds) return E_TRUNCATED;
  uint32_t dict = 0;
  for (size_t i = 0; i < ds; ++i) dict |= (uint32_t)p[q + i] << (8 * i);
  if (dict != 0) return E_DICT;
  q += ds;
  const size_t fcs_size[4] = {(size_t)(single ? 1 : 0), 2, 4, 8};
  const size_t fs = fcs_size[fcs_flag];
  if (n < q + fs) return E_TRUNCATED;
  if (fs == 0) {
    h->content = -1;
  } else {
    uint64_t v = 0;
    for (size_t i = 0; i < fs; ++i) v |= (uint64_t)p[q + i] << (8 * i);
    if (fs == 2) v += 256;
    if (v > (uint64_t)INT64_MAX) return E_HEADER;
    h->content = (int64_t)v;
  }
  q += fs;
  if (single) h->window = (uint64_t)h->content;
  h->size = q;
  return OK;
}

// Walks every frame's header and block headers without decoding: -> an
// upper bound on the decoded size (exact where each frame states its size).
int64_t bound(const uint8_t* src, size_t n) {
  size_t pos = 0;
  int64_t total = 0;
  while (pos < n) {
    if (n - pos < 4) return E_TRUNCATED;
    const uint32_t magic = le32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) return E_TRUNCATED;
      const size_t sz = le32(src + pos + 4);
      if (n - pos - 8 < sz) return E_TRUNCATED;
      pos += 8 + sz;
      continue;
    }
    if (magic != kMagic) return E_MAGIC;
    pos += 4;
    Header h;
    int rc = parse_header(src + pos, n - pos, &h);
    if (rc != OK) return rc;
    pos += h.size;
    const uint64_t block_max = h.window < kBlockMax ? h.window : kBlockMax;
    int64_t frame = 0;
    for (;;) {
      if (n - pos < 3) return E_TRUNCATED;
      const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      pos += 3;
      if (type == 3 || size > block_max) return E_BLOCK;
      const size_t body = type == 1 ? 1 : size;
      if (n - pos < body) return E_TRUNCATED;
      pos += body;
      frame += type == 2 ? (int64_t)block_max : (int64_t)size;
      if (bh & 1) break;
    }
    if (h.checksum) {
      if (n - pos < 4) return E_TRUNCATED;
      pos += 4;
    }
    total += h.content >= 0 ? h.content : frame;
  }
  return total;
}

int64_t decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t pos = 0;
  Out o{dst, cap, 0, 0};
  std::unique_ptr<Frame> F;
  while (pos < n) {
    if (n - pos < 4) return E_TRUNCATED;
    const uint32_t magic = le32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (n - pos < 8) return E_TRUNCATED;
      const size_t sz = le32(src + pos + 4);
      if (n - pos - 8 < sz) return E_TRUNCATED;
      pos += 8 + sz;
      continue;
    }
    if (magic != kMagic) return E_MAGIC;
    pos += 4;
    Header h;
    int rc = parse_header(src + pos, n - pos, &h);
    if (rc != OK) return rc;
    pos += h.size;
    F.reset(new Frame());
    o.frame_start = o.pos;
    const size_t block_max = h.window < kBlockMax ? (size_t)h.window : kBlockMax;
    for (;;) {
      if (n - pos < 3) return E_TRUNCATED;
      const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      pos += 3;
      if (type == 3 || size > block_max) return E_BLOCK;
      if (type == 0) {
        if (n - pos < size) return E_TRUNCATED;
        if (size > cap - o.pos) return E_DST_SMALL;
        std::memcpy(dst + o.pos, src + pos, size);
        o.pos += size;
        pos += size;
      } else if (type == 1) {
        if (n - pos < 1) return E_TRUNCATED;
        if (size > cap - o.pos) return E_DST_SMALL;
        std::memset(dst + o.pos, src[pos], size);
        o.pos += size;
        pos += 1;
      } else {
        if (n - pos < size) return E_TRUNCATED;
        rc = decode_block(*F, src + pos, size, o, block_max);
        if (rc != OK) return rc;
        pos += size;
      }
      if (bh & 1) break;
    }
    const size_t produced = o.pos - o.frame_start;
    if (h.content >= 0 && (uint64_t)h.content != produced) return E_SIZE;
    if (h.checksum) {
      if (n - pos < 4) return E_TRUNCATED;
      if ((uint32_t)xxh64(dst + o.frame_start, produced, 0) != le32(src + pos))
        return E_CHECKSUM;
      pos += 4;
    }
  }
  return (int64_t)o.pos;
}

// --- CRC-32C (Castagnoli, reflected 0x82F63B78), as OCDBT's files end ---------
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  static const Crc32cTable T;
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {  // slicing by 8
    const uint64_t v = le64(p) ^ crc;
    crc = T.t[7][v & 0xFF] ^ T.t[6][(v >> 8) & 0xFF] ^ T.t[5][(v >> 16) & 0xFF] ^
          T.t[4][(v >> 24) & 0xFF] ^ T.t[3][(v >> 32) & 0xFF] ^
          T.t[2][(v >> 40) & 0xFF] ^ T.t[1][(v >> 48) & 0xFF] ^ T.t[0][v >> 56];
  }
  for (; n > 0; --n, ++p) crc = (crc >> 8) ^ T.t[0][(crc ^ *p) & 0xFF];
  return ~crc;
}

}  // namespace zstd_dec
}  // extern "C++"

// Decodes every frame of src into dst: -> the bytes written, or a negative
// code (zstd_error_name). E_DST_SMALL (-13): out_cap was too small.
int64_t zstd_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                        int64_t out_cap) {
  if (src_len < 0 || out_cap < 0) return zstd_dec::E_TRUNCATED;
  return zstd_dec::decompress(src, (size_t)src_len, dst, (size_t)out_cap);
}

// An upper bound on zstd_decompress's output (exact where every frame
// states its content size), from the frame and block headers alone; or a
// negative code.
int64_t zstd_bound(const uint8_t* src, int64_t src_len) {
  if (src_len < 0) return zstd_dec::E_TRUNCATED;
  return zstd_dec::bound(src, (size_t)src_len);
}

const char* zstd_error_name(int64_t code) {
  switch (code) {
    case zstd_dec::E_TRUNCATED: return "truncated input";
    case zstd_dec::E_MAGIC: return "not a zstd frame (bad magic number)";
    case zstd_dec::E_HEADER: return "bad frame header";
    case zstd_dec::E_DICT: return "the frame needs a dictionary (not supported)";
    case zstd_dec::E_BLOCK: return "bad block (reserved type or over the block size)";
    case zstd_dec::E_LITERALS: return "bad literals section";
    case zstd_dec::E_HUFFMAN: return "bad Huffman table or stream";
    case zstd_dec::E_FSE: return "bad FSE table description";
    case zstd_dec::E_SEQUENCES: return "bad sequences section";
    case zstd_dec::E_OFFSET: return "match offset before the frame's start";
    case zstd_dec::E_CHECKSUM: return "content checksum mismatch";
    case zstd_dec::E_SIZE: return "decoded size differs from the frame's content size";
    case zstd_dec::E_DST_SMALL: return "output buffer too small";
    default: return "unknown error";
  }
}

uint32_t crc32c(const uint8_t* src, int64_t len, uint32_t crc) {
  return zstd_dec::crc32c(src, (size_t)len, crc);
}

// ---------------------------------------------------------------------------
// Multi-stream hub: per-stream sample rings + one-call block assembly for
// streaming serving (avvad_tpu.serve.MultiStreamVAD). Replaces the
// per-stream Python/numpy framing + block-assembly loop with one C call
// per tick: frames for every ready stream are written straight into the
// caller's pinned (N, block_frames, nfft) tensor.

// Sample type is templated: the hub runs either float32 (the historical
// wire) or int16 PCM end-to-end. int16 halves the span-wire payload on
// the transfer-bound serving tick and is bit-exact for 16-bit sources:
// peak normalization divides samples by the running |peak| in the SAME
// domain, so fl(i/p) on the int16 wire equals fl((i/32768)/(p/32768)) on
// the float wire — both are the once-rounded quotient of identical reals.
extern "C++" {  // templates cannot carry C linkage

template <typename T>
struct StreamBufT {
  std::vector<T> samples;
  size_t head = 0;  // consumed prefix (compacted lazily)
  float peak = 0.0f;

  size_t size() const { return samples.size() - head; }
  const T* data() const { return samples.data() + head; }

  void append(const T* pcm, int64_t n) {
    samples.insert(samples.end(), pcm, pcm + n);
  }

  void consume(size_t n) {
    head += n;
    if (head > (1u << 20) && head * 2 > samples.size()) {
      samples.erase(samples.begin(), samples.begin() + (std::ptrdiff_t)head);
      head = 0;
    }
  }
};

struct StreamHub {
  int32_t n_streams, nfft, hop, block_frames;
  int32_t i16;  // 0 = float32 samples, 1 = int16 PCM
  std::vector<StreamBufT<float>> bufs;
  std::vector<StreamBufT<int16_t>> bufs16;
};

template <typename T>
static void reset_bufs(std::vector<StreamBufT<T>>& bufs) {
  for (auto& b : bufs) {
    b.samples.clear();
    b.head = 0;
    b.peak = 0.0f;
  }
}

template <typename T>
static int64_t frames_ready(const StreamHub* h, const StreamBufT<T>& b) {
  if (b.size() < (size_t)h->nfft) return 0;
  return 1 + (int64_t)(b.size() - h->nfft) / h->hop;
}

// Buffer samples for one stream; updates the running peak. Returns the
// number of complete frames now buffered, or a negative error code.
template <typename T>
static int64_t hub_feed_impl(StreamHub* h, int32_t stream, const T* pcm,
                             int64_t n, std::vector<StreamBufT<T>>& bufs) {
  if (!h || stream < 0 || stream >= h->n_streams || n < 0)
    return AVVAD_ERR_BADARG;
  StreamBufT<T>& b = bufs[(size_t)stream];
  for (int64_t i = 0; i < n; ++i) {
    float a = std::fabs((float)pcm[i]);
    if (a > b.peak) b.peak = a;
  }
  b.append(pcm, n);
  return frames_ready(h, b);
}

template <typename T>
static int32_t span_gated_impl(StreamHub* h, const float* gate, T* out,
                               float* peaks_out, float* active_out,
                               std::vector<StreamBufT<T>>& bufs) {
  const int64_t bf = h->block_frames;
  const int64_t span = (bf - 1) * h->hop + h->nfft;
  int32_t n_active = 0;
  for (int32_t s = 0; s < h->n_streams; ++s) {
    StreamBufT<T>& b = bufs[(size_t)s];
    peaks_out[s] = b.peak;
    if ((gate && gate[s] == 0.0f) || frames_ready(h, b) < bf) {
      active_out[s] = 0.0f;
      continue;
    }
    std::memcpy(out + (int64_t)s * span, b.data(),
                (size_t)span * sizeof(T));
    b.consume((size_t)(bf * h->hop));
    active_out[s] = 1.0f;
    ++n_active;
  }
  return n_active;
}

}  // extern "C++"

// Create a hub for n_streams streams framed at (nfft, hop) and served in
// blocks of block_frames frames. Returns an opaque handle.
static void* hub_create_impl(int32_t n_streams, int32_t nfft, int32_t hop,
                             int32_t block_frames, int32_t i16) {
  if (n_streams <= 0 || nfft <= 0 || hop <= 0 || block_frames <= 0)
    return nullptr;
  auto* h = new StreamHub{n_streams, nfft, hop, block_frames, i16, {}, {}};
  if (i16)
    h->bufs16.resize((size_t)n_streams);
  else
    h->bufs.resize((size_t)n_streams);
  return h;
}

void* hub_create(int32_t n_streams, int32_t nfft, int32_t hop,
                 int32_t block_frames) {
  return hub_create_impl(n_streams, nfft, hop, block_frames, 0);
}

// int16-PCM hub: samples buffer and assemble as int16 (span wire only);
// peaks report the running max |sample| in the int16 domain.
void* hub_create_i16(int32_t n_streams, int32_t nfft, int32_t hop,
                     int32_t block_frames) {
  return hub_create_impl(n_streams, nfft, hop, block_frames, 1);
}

void hub_destroy(void* hub) { delete (StreamHub*)hub; }

void hub_reset(void* hub) {
  auto* h = (StreamHub*)hub;
  reset_bufs(h->bufs);
  reset_bufs(h->bufs16);
}

// Reset one stream (connection recycling in the serving front).
int32_t hub_reset_stream(void* hub, int32_t stream) {
  auto* h = (StreamHub*)hub;
  if (!h || stream < 0 || stream >= h->n_streams) return AVVAD_ERR_BADARG;
  if (h->i16) {
    StreamBufT<int16_t>& b = h->bufs16[(size_t)stream];
    b.samples.clear();
    b.head = 0;
    b.peak = 0.0f;
  } else {
    StreamBufT<float>& b = h->bufs[(size_t)stream];
    b.samples.clear();
    b.head = 0;
    b.peak = 0.0f;
  }
  return 0;
}

int64_t hub_feed(void* hub, int32_t stream, const float* pcm, int64_t n) {
  auto* h = (StreamHub*)hub;
  if (!h || h->i16) return AVVAD_ERR_BADARG;
  return hub_feed_impl(h, stream, pcm, n, h->bufs);
}

int64_t hub_feed_i16(void* hub, int32_t stream, const int16_t* pcm,
                     int64_t n) {
  auto* h = (StreamHub*)hub;
  if (!h || !h->i16) return AVVAD_ERR_BADARG;
  return hub_feed_impl(h, stream, pcm, n, h->bufs16);
}

int64_t hub_frames_ready(void* hub, int32_t stream) {
  auto* h = (StreamHub*)hub;
  if (!h || stream < 0 || stream >= h->n_streams) return AVVAD_ERR_BADARG;
  return h->i16 ? frames_ready(h, h->bufs16[(size_t)stream])
                : frames_ready(h, h->bufs[(size_t)stream]);
}

// One serving tick: for every stream with >= block_frames complete frames,
// write its next (block_frames, nfft) frame block into out (laid out
// (n_streams, block_frames, nfft), rows of inactive streams untouched),
// set active_out[i] = 1, record the running peak in peaks_out[i], and
// consume block_frames*hop samples (the nfft-hop overlap tail stays
// buffered). Returns the number of active streams.
//
// The gated variant additionally requires gate[s] != 0 for a stream to be
// assembled (gate == nullptr means all streams are eligible); a gated-out
// stream keeps its samples buffered. An audio-visual server uses the gate
// to hold back streams whose video side has not buffered a full block yet.
int32_t hub_assemble_gated(void* hub, const float* gate, float* out,
                           float* peaks_out, float* active_out) {
  auto* h = (StreamHub*)hub;
  if (!h || h->i16) return AVVAD_ERR_BADARG;  // frames wire is f32-only
  const int64_t bf = h->block_frames;
  const int64_t frame_stride = h->nfft;
  const int64_t stream_stride = bf * frame_stride;
  int32_t n_active = 0;
  for (int32_t s = 0; s < h->n_streams; ++s) {
    StreamBufT<float>& b = h->bufs[(size_t)s];
    peaks_out[s] = b.peak;
    if ((gate && gate[s] == 0.0f) || frames_ready(h, b) < bf) {
      active_out[s] = 0.0f;
      continue;
    }
    float* dst = out + (int64_t)s * stream_stride;
    const float* src = b.data();
    for (int64_t f = 0; f < bf; ++f)
      std::memcpy(dst + f * frame_stride, src + f * h->hop,
                  (size_t)h->nfft * sizeof(float));
    b.consume((size_t)(bf * h->hop));
    active_out[s] = 1.0f;
    ++n_active;
  }
  return n_active;
}

int32_t hub_assemble(void* hub, float* out, float* peaks_out,
                     float* active_out) {
  return hub_assemble_gated(hub, nullptr, out, peaks_out, active_out);
}

// Span-wire variant of hub_assemble_gated: instead of materializing the
// block's frames (block_frames * nfft samples, a ~nfft/hop inflation of
// the underlying signal at 75% overlap), write the block's CONTIGUOUS
// sample span ((block_frames - 1) * hop + nfft samples) per active
// stream — one memcpy per stream, and a ~3.4x smaller host->device
// payload on a transfer-bound serving tick. Framing moves on-device
// (ops/stft.frame_signal reshape/concat, or none at all with the
// hop-block DFT frontend). out is laid out (n_streams, span); same
// gate / peak / active / consume semantics as hub_assemble_gated.
int32_t hub_assemble_span_gated(void* hub, const float* gate, float* out,
                                float* peaks_out, float* active_out) {
  auto* h = (StreamHub*)hub;
  if (!h || h->i16) return AVVAD_ERR_BADARG;
  return span_gated_impl(h, gate, out, peaks_out, active_out, h->bufs);
}

// int16 span wire: half the host->device payload of the float32 span at
// identical (bit-exact, for int16-origin sources) downstream numerics —
// the device frontend casts to f32 and divides by the int-domain peak.
int32_t hub_assemble_span_gated_i16(void* hub, const float* gate,
                                    int16_t* out, float* peaks_out,
                                    float* active_out) {
  auto* h = (StreamHub*)hub;
  if (!h || !h->i16) return AVVAD_ERR_BADARG;
  return span_gated_impl(h, gate, out, peaks_out, active_out, h->bufs16);
}

}  // extern "C"
