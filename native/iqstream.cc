// iqstream — native IQ stream I/O engine for the JAX SDR framework.
//
// Plays the role UHD's device transport plays in the reference
// (/root/reference/lib/ofdmtxrx.cc:96-97 send/recv paths): moving complex
// sample blocks between storage/wire formats and the host buffers that feed
// the device, off the Python hot path.  Supports the two on-disk formats the
// framework uses plus the USRP over-the-wire format:
//
//   * CF32: interleaved float32 I/Q (the framework's .iq/.dat/.cfile)
//   * SC16: interleaved int16 I/Q (UHD's over-the-wire format; the
//     reference always converts at the driver boundary)
//
// A background reader thread double-buffers file blocks ahead of the
// consumer (the pipeline-parallel stage the reference implements with its
// RX worker pthread, lib/ofdmtxrx.cc:554-636).
//
// C ABI only (consumed via ctypes from liquid_usrp_tpu.io.native).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr float kSc16Scale = 32767.0f;

inline int16_t quantize_sc16(float v) {
  v = v * kSc16Scale;
  if (v > 32767.0f) v = 32767.0f;
  if (v < -32768.0f) v = -32768.0f;
  return static_cast<int16_t>(lroundf(v));  // nearest, not truncation
}

struct Block {
  std::vector<float> data;  // interleaved I/Q, 2 * n_samples floats
  size_t n_samples = 0;
  bool eof = false;
  bool error = false;       // ferror() on the short read (not a real EOF)
};

struct Reader {
  FILE* f = nullptr;
  int format = 0;  // 0 = CF32, 1 = SC16
  size_t block_samples = 0;
  // double buffer
  Block slots[2];
  int next_fill = 0;
  int next_read = 0;
  std::atomic<int> filled{0};
  std::mutex mu;
  std::condition_variable cv_fill, cv_read;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::atomic<bool> done{false};  // fill_loop has returned

  void fill_loop() {
    std::vector<int16_t> tmp;
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_fill.wait(lk, [&] { return filled.load() < 2 || stop.load(); });
      if (stop.load()) {
        done.store(true);
        cv_read.notify_all();
        return;
      }
      Block& b = slots[next_fill];
      lk.unlock();

      b.data.resize(2 * block_samples);
      size_t got = 0;
      if (format == 0) {
        got = fread(b.data.data(), sizeof(float) * 2, block_samples, f);
      } else {
        tmp.resize(2 * block_samples);
        got = fread(tmp.data(), sizeof(int16_t) * 2, block_samples, f);
        for (size_t i = 0; i < 2 * got; i++) {
          b.data[i] = static_cast<float>(tmp[i]) / kSc16Scale;
        }
      }
      b.n_samples = got;
      b.eof = (got < block_samples);
      b.error = b.eof && ferror(f);  // short read from I/O failure

      lk.lock();
      next_fill ^= 1;
      filled.fetch_add(1);
      cv_read.notify_one();
      if (b.eof) {
        done.store(true);
        cv_read.notify_all();
        return;
      }
    }
  }
};

}  // namespace

extern "C" {

// ---- streaming double-buffered reader ----

void* iq_reader_open(const char* path, int format, size_t block_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  r->format = format;
  r->block_samples = block_samples;
  r->worker = std::thread([r] { r->fill_loop(); });
  return r;
}

// Returns samples read into out (interleaved float I/Q, capacity
// 2*block_samples floats); 0 at EOF.
size_t iq_reader_next(void* h, float* out) {
  auto* r = static_cast<Reader*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  // Also wake when the fill thread has exited (post-EOF or racing a
  // close): without the done escape a call after the EOF block was
  // consumed would block forever.
  r->cv_read.wait(lk, [&] { return r->filled.load() > 0 || r->done.load(); });
  if (r->filled.load() == 0) return 0;
  Block& b = r->slots[r->next_read];
  size_t n = b.n_samples;
  memcpy(out, b.data.data(), 2 * n * sizeof(float));
  bool eof = b.eof;
  bool err = b.error;
  r->next_read ^= 1;
  r->filled.fetch_sub(1);
  r->cv_fill.notify_one();
  if (eof) r->stop.store(true);
  // an I/O error mid-file must not masquerade as a clean end-of-stream
  if (err) return static_cast<size_t>(-1);
  return n;
}

void iq_reader_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop.store(true);
    r->filled.store(0);
    r->cv_fill.notify_all();
  }
  if (r->worker.joinable()) r->worker.join();
  fclose(r->f);
  delete r;
}

// ---- streaming double-buffered writer (TX-side mirror) ----

namespace {

struct Writer {
  FILE* f = nullptr;
  int format = 0;
  std::deque<std::vector<float>> q;  // interleaved I/Q blocks
  size_t depth = 8;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::thread worker;
  bool closing = false;
  bool error = false;

  void drain_loop() {
    std::vector<int16_t> tmp;
    for (;;) {
      std::vector<float> blk;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_data.wait(lk, [&] { return !q.empty() || closing; });
        if (q.empty()) return;  // closing and drained
        blk = std::move(q.front());
        q.pop_front();
        cv_space.notify_one();
      }
      size_t n = blk.size() / 2;
      size_t put;
      if (format == 0) {
        put = fwrite(blk.data(), 2 * sizeof(float), n, f);
      } else {
        tmp.resize(blk.size());
        for (size_t i = 0; i < blk.size(); i++)
          tmp[i] = quantize_sc16(blk[i]);
        put = fwrite(tmp.data(), 2 * sizeof(int16_t), n, f);
      }
      if (put != n) {
        std::lock_guard<std::mutex> lk(mu);
        error = true;
      }
    }
  }
};

}  // namespace

// Background writer: push() enqueues a block and returns immediately (the
// TX worker decoupling of the reference's sample streaming, bounded queue
// applies backpressure); close() drains and reports any write error.
void* iq_writer_open(const char* path, int format, size_t depth) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->format = format;
  if (depth) w->depth = depth;
  w->worker = std::thread([w] { w->drain_loop(); });
  return w;
}

int iq_writer_push(void* h, const float* data, size_t n_samples) {
  auto* w = static_cast<Writer*>(h);
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv_space.wait(lk, [&] { return w->q.size() < w->depth || w->closing; });
  if (w->closing) return -1;
  w->q.emplace_back(data, data + 2 * n_samples);
  w->cv_data.notify_one();
  return w->error ? -1 : 0;
}

int iq_writer_close(void* h) {
  auto* w = static_cast<Writer*>(h);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->closing = true;
    w->cv_data.notify_all();
    w->cv_space.notify_all();
  }
  if (w->worker.joinable()) w->worker.join();
  // fclose flushes stdio's buffer — a full disk surfaces HERE, not at
  // the fwrite that merely buffered the tail
  int close_rc = fclose(w->f);
  int rc = (w->error || close_rc != 0) ? -1 : 0;
  delete w;
  return rc;
}

// ---- one-shot bulk conversion / file I/O ----

size_t iq_file_size_samples(const char* path, int format) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  long bytes = -1;
  if (fseek(f, 0, SEEK_END) == 0) bytes = ftell(f);
  fclose(f);
  if (bytes < 0) return static_cast<size_t>(-1);  // non-seekable / error
  return static_cast<size_t>(bytes) /
         (format == 0 ? 2 * sizeof(float) : 2 * sizeof(int16_t));
}

size_t iq_read_file(const char* path, int format, float* out,
                    size_t max_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  size_t got;
  if (format == 0) {
    got = fread(out, 2 * sizeof(float), max_samples, f);
  } else {
    std::vector<int16_t> tmp(2 * max_samples);
    got = fread(tmp.data(), 2 * sizeof(int16_t), max_samples, f);
    for (size_t i = 0; i < 2 * got; i++)
      out[i] = static_cast<float>(tmp[i]) / kSc16Scale;
  }
  bool err = (got < max_samples) && ferror(f);
  fclose(f);
  if (err) return static_cast<size_t>(-1);
  return got;
}

int iq_write_file(const char* path, int format, const float* data,
                  size_t n_samples) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t put;
  if (format == 0) {
    put = fwrite(data, 2 * sizeof(float), n_samples, f);
  } else {
    std::vector<int16_t> tmp(2 * n_samples);
    for (size_t i = 0; i < 2 * n_samples; i++)
      tmp[i] = quantize_sc16(data[i]);
    put = fwrite(tmp.data(), 2 * sizeof(int16_t), n_samples, f);
  }
  int close_rc = fclose(f);
  return (put == n_samples && close_rc == 0) ? 0 : -1;
}

// ---- cf32 -> bfloat16 I/Q planes (reduced-precision device ingest) ----
//
// Deinterleaves and rounds in one pass: ``out`` receives 2*n uint16
// values — first n = I plane, then n = Q plane (the [2, L] layout
// liquid_usrp_tpu.ops.iqfmt consumes).  Round-to-nearest-even matches
// XLA's / ml_dtypes' f32->bf16 conversion bit-exactly for finite values.

static inline uint16_t f32_to_bf16(float v) {
  uint32_t bits;
  memcpy(&bits, &v, 4);
  if ((bits & 0x7F800000u) == 0x7F800000u) {
    // NaN/Inf: truncate (rounding's mantissa carry can ripple through
    // the exponent into the sign, turning NaN into +-0); keep a quiet
    // bit so a payload-less NaN stays NaN
    uint16_t hi = static_cast<uint16_t>(bits >> 16);
    if ((bits & 0x007FFFFFu) != 0 && (hi & 0x7Fu) == 0) hi |= 0x40u;
    return hi;
  }
  uint32_t lsb = (bits >> 16) & 1u;
  bits += 0x7FFFu + lsb;  // round to nearest, ties to even
  return static_cast<uint16_t>(bits >> 16);
}

void iq_cf32_to_bf16_planes(const float* in, uint16_t* out,
                            size_t n_samples) {
  for (size_t i = 0; i < n_samples; i++) {
    out[i] = f32_to_bf16(in[2 * i]);
    out[n_samples + i] = f32_to_bf16(in[2 * i + 1]);
  }
}

// cf32 -> int8 "SC8" wire-code planes (ops/iqfmt.py convention:
// +-127 <-> +-1.0 full scale, caller is the AGC).  nearbyintf under the
// default FP environment rounds to nearest-even, matching np.round /
// jnp.round in the Python quantizers bit-exactly; out-of-range clips.
void iq_cf32_to_sc8_planes(const float* in, int8_t* out,
                           size_t n_samples) {
  for (size_t i = 0; i < n_samples; i++) {
    for (int p = 0; p < 2; p++) {
      float v = nearbyintf(in[2 * i + p] * 127.0f);
      if (v > 127.0f) v = 127.0f;
      if (v < -127.0f) v = -127.0f;
      out[p * n_samples + i] = static_cast<int8_t>(v);
    }
  }
}

// ---- sc16 <-> cf32 buffer converters (wire-format boundary) ----

void iq_sc16_to_cf32(const int16_t* in, float* out, size_t n_samples) {
  for (size_t i = 0; i < 2 * n_samples; i++)
    out[i] = static_cast<float>(in[i]) / kSc16Scale;
}

void iq_cf32_to_sc16(const float* in, int16_t* out, size_t n_samples) {
  for (size_t i = 0; i < 2 * n_samples; i++)
    out[i] = quantize_sc16(in[i]);
}

}  // extern "C"
