// avvad_io: native host-IO core for the avvad_tpu data pipeline.
//
// The framework's host-side hot path during training/eval is WAV decode +
// peak normalization + (for label building) frame-energy VAD over millions
// of utterance reads. The reference does all of this through Python
// (torchaudio/librosa); here the inner loops are C++ behind a minimal C ABI
// consumed via ctypes (no pybind11 dependency).
//
// Also LZF decompression for the port's HDF5 reader (avvad_tpu_torch/hdf5.py).
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
