// Native multi-threaded audio data loader for codec/vocoder training.
//
// The port's own copy of lina_speech_tpu/native/audioloader.cpp, with the
// same code. It replaces the reference's torch DataLoader
// workers + soundfile path (decoder/dataset.py:44-84): N worker threads
// parse WAV files (PCM16 / PCM32 / IEEE float32, any channel count -> mono
// mean), random-crop a fixed window, apply the random gain normalization
// the reference applies in training (-1..-6 dBFS target), and push batches
// into a bounded queue the Python side drains via ctypes
// (lina_speech_tpu_torch/data/audio_loader.py). Decode, crop and
// normalization stay off the Python thread that feeds the GPU.
//
// C ABI only (no pybind11); built with g++ at first use into
// build/audioloader/ (data/audio_loader.py:build_native).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>
#include <cstdio>
#include <cmath>

namespace {

struct WavData {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
};

bool read_wav(const std::string& path, WavData* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  auto rd_u32 = [&](uint32_t* v) { return fread(v, 4, 1, f) == 1; };
  auto rd_u16 = [&](uint16_t* v) { return fread(v, 2, 1, f) == 1; };
  char tag[4];
  uint32_t riff_size;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) || !rd_u32(&riff_size) ||
      fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4)) {
    fclose(f);
    return false;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool got_fmt = false;
  while (fread(tag, 1, 4, f) == 4) {
    uint32_t size;
    if (!rd_u32(&size)) break;
    if (!memcmp(tag, "fmt ", 4)) {
      uint32_t byte_rate;
      uint16_t block_align;
      if (!rd_u16(&fmt) || !rd_u16(&channels) || !rd_u32(&sample_rate) ||
          !rd_u32(&byte_rate) || !rd_u16(&block_align) || !rd_u16(&bits)) break;
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
      got_fmt = true;
    } else if (!memcmp(tag, "data", 4)) {
      if (!got_fmt) break;
      size_t n_frames = size / (channels * (bits / 8));
      out->samples.assign(n_frames, 0.f);
      out->sample_rate = (int)sample_rate;
      std::vector<uint8_t> raw(size);
      if (fread(raw.data(), 1, size, f) != size) break;
      const float inv_ch = channels ? 1.f / channels : 1.f;
      for (size_t i = 0; i < n_frames; ++i) {
        float acc = 0.f;
        for (int c = 0; c < channels; ++c) {
          size_t off = (i * channels + c) * (bits / 8);
          if (fmt == 1 && bits == 16) {
            int16_t s;
            memcpy(&s, raw.data() + off, 2);
            acc += s / 32768.f;
          } else if (fmt == 1 && bits == 32) {
            int32_t s;
            memcpy(&s, raw.data() + off, 4);
            acc += s / 2147483648.f;
          } else if (fmt == 3 && bits == 32) {
            float s;
            memcpy(&s, raw.data() + off, 4);
            acc += s;
          }
        }
        out->samples[i] = acc * inv_ch;
      }
      fclose(f);
      return !out->samples.empty();
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  return false;
}

struct Loader {
  std::vector<std::string> paths;
  int crop_len = 0;
  int batch = 0;
  float gain_db_min = -6.f, gain_db_max = -1.f;
  bool train = true;

  std::deque<std::vector<float>> queue;  // each: batch * crop_len
  size_t max_queue = 4;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker(uint64_t seed) {
    std::mt19937_64 rng(seed);
    std::uniform_int_distribution<size_t> pick(0, paths.size() - 1);
    std::uniform_real_distribution<float> gain_dist(gain_db_min, gain_db_max);
    std::vector<float> item((size_t)batch * crop_len);
    while (!stop.load()) {
      for (int b = 0; b < batch; ++b) {
        WavData wav;
        // retry until a file parses (corrupt files are skipped, as the
        // reference's soundfile loader would raise per-item)
        int guard = 0;
        while (!read_wav(paths[pick(rng)], &wav) && ++guard < 64 && !stop.load()) {
        }
        float* dst = item.data() + (size_t)b * crop_len;
        size_t n = wav.samples.size();
        if (n == 0) {
          memset(dst, 0, sizeof(float) * crop_len);
          continue;
        }
        size_t start = 0;
        if (n > (size_t)crop_len && train) {
          std::uniform_int_distribution<size_t> s(0, n - crop_len);
          start = s(rng);
        }
        float peak = 1e-9f;
        for (size_t i = 0; i < n; ++i) peak = std::max(peak, std::fabs(wav.samples[i]));
        float gain = std::pow(10.f, gain_dist(rng) / 20.f) / peak;
        for (int i = 0; i < crop_len; ++i) {
          size_t src = start + i;
          dst[i] = src < n ? wav.samples[src] * gain : 0.f;
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < max_queue || stop.load(); });
      if (stop.load()) return;
      queue.push_back(item);
      cv_pop.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int crop_len, int batch,
                    int n_threads, uint64_t seed, int train) {
  if (n_paths <= 0) return nullptr;
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->crop_len = crop_len;
  L->batch = batch;
  L->train = train != 0;
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back([L, seed, i] { L->worker(seed + 0x9e3779b9ull * i); });
  return L;
}

// Fills out[batch * crop_len]; returns 0 on success.
int loader_next(void* handle, float* out) {
  auto* L = static_cast<Loader*>(handle);
  std::vector<float> item;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [&] { return !L->queue.empty() || L->stop.load(); });
    if (L->queue.empty()) return 1;
    item = std::move(L->queue.front());
    L->queue.pop_front();
    L->cv_push.notify_one();
  }
  memcpy(out, item.data(), item.size() * sizeof(float));
  return 0;
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
