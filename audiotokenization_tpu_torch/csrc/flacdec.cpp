// Native FLAC decoder for the audio data pipeline.
//
// The reference loads LibriSpeech FLAC through torchaudio/soundfile (C
// libsndfile underneath, BigCodec_SSL/data_module.py:95, extract_indices.py
// load_libritts_item). This is the TPU framework's native equivalent: a
// self-contained FLAC (subset) decoder — constant/verbatim/fixed/LPC
// subframes, Rice-coded residual partitions, UTF-8 frame headers,
// left/right/mid-side decorrelation — exposed over a C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -o libflacdec.so flacdec.cpp
// (done automatically by audiotokenization_tpu/data/flac.py)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t len) : data_(data), len_(len) {}

  bool ok() const { return !error_; }
  size_t byte_pos() const { return pos_; }

  void align() {
    if (bit_) {
      bit_ = 0;
      ++pos_;
    }
  }

  uint32_t read_bits(int n) {  // n <= 32
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  uint64_t read_bits64(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits64(n);
    uint64_t sign = 1ULL << (n - 1);
    return (v & sign) ? (int64_t)(v - (sign << 1)) : (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (ok() && read_bit() == 0) ++q;
    return q;
  }

  uint32_t read_bit() {
    if (pos_ >= len_) {
      error_ = true;
      return 0;
    }
    uint32_t b = (data_[pos_] >> (7 - bit_)) & 1;
    if (++bit_ == 8) {
      bit_ = 0;
      ++pos_;
    }
    return b;
  }

  void skip_bytes(size_t n) {
    pos_ += n;
    if (pos_ > len_) error_ = true;
  }

 private:
  const uint8_t* data_;
  size_t len_;
  size_t pos_ = 0;
  int bit_ = 0;
  bool error_ = false;
};

// UTF-8-style coded number in frame headers (up to 36 bits).
uint64_t read_utf8(BitReader& br) {
  uint32_t b0 = br.read_bits(8);
  if (b0 < 0x80) return b0;
  int n = 0;
  for (uint32_t mask = 0x40; b0 & mask; mask >>= 1) ++n;
  uint64_t v = b0 & (0x3F >> n);
  for (int i = 0; i < n; ++i) v = (v << 6) | (br.read_bits(8) & 0x3F);
  return v;
}

bool decode_residual(BitReader& br, int order, int block_size,
                     std::vector<int64_t>& out) {
  uint32_t method = br.read_bits(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 15 : 31;
  uint32_t partition_order = br.read_bits(4);
  uint32_t partitions = 1u << partition_order;
  int samples_per = block_size >> partition_order;
  int idx = order;
  for (uint32_t p = 0; p < partitions; ++p) {
    int count = samples_per - (p == 0 ? order : 0);
    uint32_t param = br.read_bits(param_bits);
    if (param == escape) {
      uint32_t raw_bits = br.read_bits(5);
      for (int i = 0; i < count; ++i)
        out[idx++] = raw_bits ? br.read_signed(raw_bits) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t u = ((uint64_t)q << param) | br.read_bits64(param);
        out[idx++] = (u & 1) ? -((int64_t)(u >> 1)) - 1 : (int64_t)(u >> 1);
      }
    }
    if (!br.ok()) return false;
  }
  return idx == block_size;
}

const int kFixedCoefs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  if (br.read_bits(1) != 0) return false;  // padding bit
  uint32_t type = br.read_bits(6);
  int wasted = 0;
  if (br.read_bits(1)) wasted = 1 + (int)br.read_unary();
  bps -= wasted;
  out.assign(block_size, 0);

  if (type == 0) {  // constant
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // fixed, order 0-4
    int order = type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += kFixedCoefs[order][j] * out[i - 1 - j];
      out[i] += pred;
    }
  } else if (type >= 32) {  // LPC, order 1-32
    int order = (int)(type & 31) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    uint32_t precision = br.read_bits(4);
    if (precision == 15) return false;
    precision += 1;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed((int)precision);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
  return br.ok();
}

const int kBlockSizes[16] = {0,   192,  576,  1152, 2304, 4608, -1, -2,
                             256, 512,  1024, 2048, 4096, 8192, 16384, 32768};

}  // namespace

extern "C" {

// Decodes a whole FLAC stream. Returns 0 on success. Caller frees *out with
// flac_free. Samples are interleaved int32 at the stream's bit depth.
int flac_decode(const uint8_t* data, size_t len, int32_t** out,
                int64_t* out_samples, int* out_channels, int* out_rate,
                int* out_bps) {
  if (len < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  int sample_rate = 0, channels = 0, bps = 0;
  int64_t total = 0;
  bool last = false;
  while (!last && pos + 4 <= len) {
    uint8_t hdr = data[pos];
    last = hdr & 0x80;
    int type = hdr & 0x7F;
    uint32_t size = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (type == 0 && size >= 34) {  // STREAMINFO
      const uint8_t* p = data + pos;
      sample_rate = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
      channels = ((p[12] >> 1) & 0x7) + 1;
      bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      total = ((int64_t)(p[13] & 0xF) << 32) | ((int64_t)p[14] << 24) |
              (p[15] << 16) | (p[16] << 8) | p[17];
    }
    pos += size;
  }
  if (sample_rate == 0 || channels == 0 || pos > len) return -2;

  std::vector<int32_t> pcm;
  if (total > 0) pcm.reserve((size_t)total * channels);

  BitReader br(data + pos, len - pos);
  std::vector<std::vector<int64_t>> chan(channels);

  while (br.ok()) {
    // frame sync
    br.align();
    uint32_t sync = br.read_bits(14);
    if (!br.ok()) break;
    if (sync != 0x3FFE) return -3;
    br.read_bits(1);                       // reserved
    br.read_bits(1);                       // blocking strategy
    uint32_t bs_code = br.read_bits(4);
    uint32_t sr_code = br.read_bits(4);
    uint32_t ch_code = br.read_bits(4);
    uint32_t ss_code = br.read_bits(3);
    br.read_bits(1);  // reserved
    read_utf8(br);    // frame/sample number

    int block_size;
    if (bs_code == 6)
      block_size = (int)br.read_bits(8) + 1;
    else if (bs_code == 7)
      block_size = (int)br.read_bits(16) + 1;
    else if (kBlockSizes[bs_code] > 0)
      block_size = kBlockSizes[bs_code];
    else
      return -4;

    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

    int frame_bps = bps;
    switch (ss_code) {
      case 1: frame_bps = 8; break;
      case 2: frame_bps = 12; break;
      case 4: frame_bps = 16; break;
      case 5: frame_bps = 20; break;
      case 6: frame_bps = 24; break;
      case 7: frame_bps = 32; break;
      default: break;  // 0 = from STREAMINFO
    }
    br.read_bits(8);  // CRC-8

    int n_ch = channels;
    int mode = 0;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code <= 7) {
      n_ch = (int)ch_code + 1;
    } else if (ch_code == 8) { n_ch = 2; mode = 1; }
    else if (ch_code == 9) { n_ch = 2; mode = 2; }
    else if (ch_code == 10) { n_ch = 2; mode = 3; }
    else return -5;
    if (n_ch != channels) return -6;

    for (int c = 0; c < n_ch; ++c) {
      int sub_bps = frame_bps;
      if ((mode == 1 && c == 1) || (mode == 2 && c == 0) || (mode == 3 && c == 1))
        sub_bps += 1;  // side channel carries one extra bit
      if (!decode_subframe(br, block_size, sub_bps, chan[c])) return -7;
    }
    br.align();
    br.read_bits(16);  // frame CRC-16

    // undo stereo decorrelation
    if (mode == 1) {  // left/side: right = left - side
      for (int i = 0; i < block_size; ++i) chan[1][i] = chan[0][i] - chan[1][i];
    } else if (mode == 2) {  // right/side: left = right + side
      for (int i = 0; i < block_size; ++i) chan[0][i] = chan[1][i] + chan[0][i];
    } else if (mode == 3) {  // mid/side
      for (int i = 0; i < block_size; ++i) {
        int64_t side = chan[1][i];
        int64_t mid = (chan[0][i] << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }

    for (int i = 0; i < block_size; ++i)
      for (int c = 0; c < channels; ++c) pcm.push_back((int32_t)chan[c][i]);

    if (total > 0 && (int64_t)pcm.size() >= total * channels) break;
  }

  int64_t n = (int64_t)pcm.size() / channels;
  if (total > 0 && n > total) n = total;
  int32_t* buf = (int32_t*)malloc((size_t)n * channels * sizeof(int32_t));
  if (!buf) return -8;
  memcpy(buf, pcm.data(), (size_t)n * channels * sizeof(int32_t));
  *out = buf;
  *out_samples = n;
  *out_channels = channels;
  *out_rate = sample_rate;
  *out_bps = bps;
  return 0;
}

void flac_free(int32_t* p) { free(p); }

}  // extern "C"
