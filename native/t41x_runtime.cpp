// t41x native runtime: block streaming, pacing, and capture I/O.
//
// Native re-expression of the reference firmware's runtime layer
// (tmr4/T41_SDR): the Teensy audio library's DMA-fed block queues
// (AudioRecordQueue/AudioPlayQueue, T41_SDR.ino:172-251), the
// back-pressure/overflow policy (Process.cpp:93-153), the real-time
// block pacing + processor-load accounting (Process.cpp:94,941;
// InfoBox.cpp:341-371), and the SD WAV reader (Utility.cpp:773-888).
//
// The device compute path stays in JAX/XLA; this library is the host-side
// plumbing around it: lock-free SPSC block rings between an acquisition
// thread and the compute loop, a paced file streamer that replays
// captures at real-time (or max) rate, and WAV parsing tuned for large
// captures.  Exposed as a C ABI for ctypes (no pybind11 dependency).
//
// Build: see native/Makefile (g++ -O2 -shared -fPIC -pthread).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using clock_t_ = std::chrono::steady_clock;

double now_s() {
    return std::chrono::duration<double>(clock_t_::now().time_since_epoch())
        .count();
}

// ---------------------------------------------------------------------
// Lock-free single-producer single-consumer ring of fixed-size blocks.
// Equivalent of the reference's AudioRecordQueue (its "available()/
// readBuffer()/freeBuffer()" protocol) with the same overflow policy:
// when the queue backs up past a high-water mark the producer clears
// backlog (Process.cpp:144-153).
// ---------------------------------------------------------------------
struct BlockRing {
    std::vector<float> data;   // capacity * block_floats
    size_t block_floats;
    size_t capacity;           // number of blocks
    std::atomic<uint64_t> head{0};  // next write slot
    std::atomic<uint64_t> tail{0};  // next read slot
    std::atomic<uint64_t> overruns{0};
    size_t highwater;

    BlockRing(size_t block_floats_, size_t capacity_)
        : data(block_floats_ * capacity_),
          block_floats(block_floats_),
          capacity(capacity_),
          highwater(capacity_ > 4 ? capacity_ - 2 : capacity_) {}

    size_t available() const {
        return static_cast<size_t>(head.load(std::memory_order_acquire) -
                                   tail.load(std::memory_order_acquire));
    }

    bool push(const float* block) {
        uint64_t h = head.load(std::memory_order_relaxed);
        uint64_t t = tail.load(std::memory_order_acquire);
        if (h - t >= highwater) {
            // overflow: drop backlog like the reference's Q_in clear
            tail.store(h, std::memory_order_release);
            overruns.fetch_add(1, std::memory_order_relaxed);
            t = h;
        }
        if (h - t >= capacity) return false;
        std::memcpy(&data[(h % capacity) * block_floats], block,
                    block_floats * sizeof(float));
        head.store(h + 1, std::memory_order_release);
        return true;
    }

    bool pop(float* out) {
        uint64_t t = tail.load(std::memory_order_relaxed);
        if (head.load(std::memory_order_acquire) == t) return false;
        std::memcpy(out, &data[(t % capacity) * block_floats],
                    block_floats * sizeof(float));
        tail.store(t + 1, std::memory_order_release);
        return true;
    }
};

// ---------------------------------------------------------------------
// Paced capture streamer: feeds blocks from a memory buffer into a ring
// at real-time rate (sample_rate), like the I2S DMA interrupt cadence.
// rate_factor > 1 replays faster than real time; 0 = as fast as possible.
// ---------------------------------------------------------------------
struct Streamer {
    BlockRing* ring = nullptr;
    std::vector<float> samples;   // interleaved I/Q (or mono audio)
    size_t block_floats = 0;
    double block_seconds = 0.0;
    double rate_factor = 1.0;
    std::thread thread;
    std::atomic<bool> running{false};
    std::atomic<uint64_t> blocks_sent{0};

    void run() {
        size_t pos = 0;
        double next = now_s();
        while (running.load(std::memory_order_relaxed) &&
               pos + block_floats <= samples.size()) {
            if (rate_factor > 0) {
                next += block_seconds / rate_factor;
                double dt = next - now_s();
                if (dt > 0)
                    std::this_thread::sleep_for(
                        std::chrono::duration<double>(dt));
            }
            ring->push(&samples[pos]);
            pos += block_floats;
            blocks_sent.fetch_add(1, std::memory_order_relaxed);
        }
        running.store(false, std::memory_order_release);
    }
};

// ---------------------------------------------------------------------
// Processor-load accounting (the reference's one perf metric:
// elapsed_micros_mean / block budget, InfoBox.cpp:341-371).
// ---------------------------------------------------------------------
struct LoadMeter {
    double budget_s;
    double sum_s = 0.0;
    uint64_t count = 0;
    double t0 = 0.0;
};

}  // namespace

extern "C" {

// ----- ring API -------------------------------------------------------
void* t41x_ring_create(size_t block_floats, size_t capacity) {
    return new BlockRing(block_floats, capacity);
}
void t41x_ring_destroy(void* r) { delete static_cast<BlockRing*>(r); }
size_t t41x_ring_available(void* r) {
    return static_cast<BlockRing*>(r)->available();
}
int t41x_ring_push(void* r, const float* block) {
    return static_cast<BlockRing*>(r)->push(block) ? 1 : 0;
}
int t41x_ring_pop(void* r, float* out) {
    return static_cast<BlockRing*>(r)->pop(out) ? 1 : 0;
}
uint64_t t41x_ring_overruns(void* r) {
    return static_cast<BlockRing*>(r)->overruns.load();
}

// ----- streamer API ---------------------------------------------------
void* t41x_streamer_create(void* ring, const float* samples,
                           size_t n_floats, size_t block_floats,
                           double block_seconds, double rate_factor) {
    auto* s = new Streamer();
    s->ring = static_cast<BlockRing*>(ring);
    s->samples.assign(samples, samples + n_floats);
    s->block_floats = block_floats;
    s->block_seconds = block_seconds;
    s->rate_factor = rate_factor;
    s->running.store(true);
    s->thread = std::thread([s] { s->run(); });
    return s;
}
int t41x_streamer_running(void* sp) {
    return static_cast<Streamer*>(sp)->running.load() ? 1 : 0;
}
uint64_t t41x_streamer_blocks_sent(void* sp) {
    return static_cast<Streamer*>(sp)->blocks_sent.load();
}
void t41x_streamer_destroy(void* sp) {
    auto* s = static_cast<Streamer*>(sp);
    s->running.store(false);
    if (s->thread.joinable()) s->thread.join();
    delete s;
}

// ----- load meter -----------------------------------------------------
void* t41x_load_create(double budget_s) {
    auto* m = new LoadMeter();
    m->budget_s = budget_s;
    return m;
}
void t41x_load_begin(void* mp) {
    static_cast<LoadMeter*>(mp)->t0 = now_s();
}
void t41x_load_end(void* mp) {
    auto* m = static_cast<LoadMeter*>(mp);
    m->sum_s += now_s() - m->t0;
    m->count += 1;
}
double t41x_load_percent(void* mp) {
    auto* m = static_cast<LoadMeter*>(mp);
    if (m->count == 0) return 0.0;
    return 100.0 * (m->sum_s / m->count) / m->budget_s;
}
void t41x_load_destroy(void* mp) { delete static_cast<LoadMeter*>(mp); }

// ----- WAV reader (PCM16 / float32, arbitrary fmt-chunk sizes) --------
// Returns number of frames, fills rate/channels; caller frees with
// t41x_wav_free.  Mirrors the tolerant parsing of the reference's
// load_wav (16/18/40-byte fmt chunks).
float* t41x_wav_read(const char* path, uint32_t* rate,
                     uint32_t* channels, uint64_t* frames) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    char id[4];
    uint32_t sz;
    if (std::fread(id, 1, 4, f) != 4 || std::memcmp(id, "RIFF", 4) ||
        std::fread(&sz, 4, 1, f) != 1 || std::fread(id, 1, 4, f) != 4 ||
        std::memcmp(id, "WAVE", 4)) {
        std::fclose(f);
        return nullptr;
    }
    uint16_t fmt = 0, nch = 0, bits = 0;
    uint32_t srate = 0;
    float* out = nullptr;
    uint64_t nframes = 0;
    while (std::fread(id, 1, 4, f) == 4 && std::fread(&sz, 4, 1, f) == 1) {
        if (!std::memcmp(id, "fmt ", 4)) {
            uint8_t buf[64] = {0};
            std::fread(buf, 1, sz < 64 ? sz : 64, f);
            if (sz > 64) std::fseek(f, sz - 64, SEEK_CUR);
            std::memcpy(&fmt, buf + 0, 2);
            std::memcpy(&nch, buf + 2, 2);
            std::memcpy(&srate, buf + 4, 4);
            std::memcpy(&bits, buf + 14, 2);
        } else if (!std::memcmp(id, "data", 4)) {
            if (bits == 16) {
                std::vector<int16_t> raw(sz / 2);
                size_t got = std::fread(raw.data(), 2, raw.size(), f);
                nframes = nch ? got / nch : 0;
                out = static_cast<float*>(
                    malloc(sizeof(float) * got));
                for (size_t i = 0; i < got; ++i)
                    out[i] = raw[i] / 32768.0f;
            } else if (bits == 32 && fmt == 3) {
                out = static_cast<float*>(malloc(sz));
                size_t got = std::fread(out, 4, sz / 4, f);
                nframes = nch ? got / nch : 0;
            } else {
                std::fseek(f, sz + (sz & 1), SEEK_CUR);
                continue;
            }
            break;
        } else {
            std::fseek(f, sz + (sz & 1), SEEK_CUR);
        }
    }
    std::fclose(f);
    if (!out) return nullptr;
    *rate = srate;
    *channels = nch;
    *frames = nframes;
    return out;
}
void t41x_wav_free(float* p) { free(p); }

}  // extern "C"
