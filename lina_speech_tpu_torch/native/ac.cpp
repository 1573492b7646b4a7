// Native arithmetic (range) coder -- bit-exact mirror of the Python coder in
// codec/ac.py.
//
// The entropy-coding loop is host-side by nature (sequential,
// data-dependent branching on every bit); Python pays ~10s of us per
// symbol in interpreter dispatch, this runs the same integer algorithm
// at memory speed. Same contract as the Python classes: P=32 internal
// precision, MSB-first bitstream, pending-bit carry resolution, decoder
// reads 0 past the end. Built with g++ by codec/ac.py:build_native into
// build/ac/ (as native/audioloader.cpp is); ctypes C ABI below.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitPacker {
  std::vector<uint8_t> bytes;
  uint32_t cur = 0;
  int n = 0;
  void push(int bit) {
    cur = (cur << 1) | (bit & 1);
    if (++n == 8) {
      bytes.push_back(static_cast<uint8_t>(cur));
      cur = 0;
      n = 0;
    }
  }
  void flush() {
    if (n) {
      bytes.push_back(static_cast<uint8_t>(cur << (8 - n)));
      cur = 0;
      n = 0;
    }
  }
};

struct BitUnpacker {
  std::vector<uint8_t> data;
  size_t pos = 0;
  int pull() {
    size_t byte = pos >> 3, bit = pos & 7;
    ++pos;
    if (byte >= data.size()) return 0;
    return (data[byte] >> (7 - bit)) & 1;
  }
};

constexpr uint64_t kHalf = 1ull << 31;     // P = 32
constexpr uint64_t kQuarter = 1ull << 30;
constexpr uint64_t kTop = (1ull << 32) - 1;

struct Encoder {
  uint64_t low = 0, high = kTop, pending = 0;
  BitPacker pk;
  bool flushed = false;

  void emit(int bit) {
    pk.push(bit);
    while (pending) {
      pk.push(1 - bit);
      --pending;
    }
  }
  void push(const int64_t* cdf, int n, int sym) {
    uint64_t total = static_cast<uint64_t>(cdf[n]);
    uint64_t span = high - low + 1;
    high = low + span * static_cast<uint64_t>(cdf[sym + 1]) / total - 1;
    low = low + span * static_cast<uint64_t>(cdf[sym]) / total;
    for (;;) {
      if (high < kHalf) {
        emit(0);
      } else if (low >= kHalf) {
        emit(1);
        low -= kHalf;
        high -= kHalf;
      } else if (low >= kQuarter && high < 3 * kQuarter) {
        ++pending;
        low -= kQuarter;
        high -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) | 1;
    }
  }
  void flush() {
    if (flushed) return;
    flushed = true;
    ++pending;
    emit(low < kQuarter ? 0 : 1);
    pk.flush();
  }
};

struct Decoder {
  uint64_t low = 0, high = kTop, value = 0;
  BitUnpacker up;

  explicit Decoder(const uint8_t* data, size_t len) {
    up.data.assign(data, data + len);
    for (int i = 0; i < 32; ++i) value = (value << 1) | up.pull();
  }
  int pull(const int64_t* cdf, int n) {
    uint64_t total = static_cast<uint64_t>(cdf[n]);
    uint64_t span = high - low + 1;
    uint64_t offset = ((value - low + 1) * total - 1) / span;
    // np.searchsorted(cdf, offset, side="right") - 1
    int lo = 0, hi = n + 1;  // first index with cdf[idx] > offset
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (static_cast<uint64_t>(cdf[mid]) > offset) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    int sym = lo - 1;
    high = low + span * static_cast<uint64_t>(cdf[sym + 1]) / total - 1;
    low = low + span * static_cast<uint64_t>(cdf[sym]) / total;
    for (;;) {
      if (high < kHalf) {
        // renormalize only
      } else if (low >= kHalf) {
        low -= kHalf;
        high -= kHalf;
        value -= kHalf;
      } else if (low >= kQuarter && high < 3 * kQuarter) {
        low -= kQuarter;
        high -= kQuarter;
        value -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) | 1;
      value = (value << 1) | up.pull();
    }
    return sym;
  }
};

}  // namespace

extern "C" {

void* ac_enc_create() { return new Encoder(); }

void ac_enc_push(void* h, const int64_t* cdf, int n, int sym) {
  static_cast<Encoder*>(h)->push(cdf, n, sym);
}

// m symbols, each with its own (n+1)-entry cdf (row-major (m, n+1)).
void ac_enc_push_many(void* h, const int64_t* cdfs, const int32_t* syms,
                      int m, int n) {
  Encoder* e = static_cast<Encoder*>(h);
  for (int i = 0; i < m; ++i) e->push(cdfs + i * (n + 1), n, syms[i]);
}

int64_t ac_enc_flush_size(void* h) {
  Encoder* e = static_cast<Encoder*>(h);
  e->flush();
  return static_cast<int64_t>(e->pk.bytes.size());
}

void ac_enc_copy(void* h, uint8_t* out) {
  Encoder* e = static_cast<Encoder*>(h);
  std::memcpy(out, e->pk.bytes.data(), e->pk.bytes.size());
}

void ac_enc_destroy(void* h) { delete static_cast<Encoder*>(h); }

void* ac_dec_create(const uint8_t* data, int64_t len) {
  return new Decoder(data, static_cast<size_t>(len));
}

int ac_dec_pull(void* h, const int64_t* cdf, int n) {
  return static_cast<Decoder*>(h)->pull(cdf, n);
}

void ac_dec_pull_many(void* h, const int64_t* cdfs, int m, int n,
                      int32_t* out) {
  Decoder* d = static_cast<Decoder*>(h);
  for (int i = 0; i < m; ++i) out[i] = d->pull(cdfs + i * (n + 1), n);
}

void ac_dec_destroy(void* h) { delete static_cast<Decoder*>(h); }

}  // extern "C"
