// Host I/O routines of the PyTorch port: the zlib column codec, the
// prefetch channel reader, the partition file writer, the bounded FIFO
// and the TLV property block codec.
//
// A copy of the I/O part of dryad_tpu/runtime/native/dryadnative.cpp
// (dn_compress .. dn_tlv_decode), so the port never loads the JAX
// package's library.  The partition writer's JSON header must stay byte
// for byte the one columnar/io.py::write_partition_file writes (key
// order, ", " and ": " separators, dtype strings), so a store written by
// either package reads back in the other.  Built with -lz -pthread.
//
// Exposed as a C ABI for ctypes; see runtime/bindings.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ------------------------------------------------------ zlib transforms
// Channel compression transform (reference TransformType gzip/deflate,
// dryadvertex.h:33-48).  Returns compressed size or 0 on error.
size_t dn_compress(const uint8_t* src, size_t src_len, uint8_t* dst,
                   size_t dst_cap, int level) {
  uLongf out_len = (uLongf)dst_cap;
  int rc = compress2(dst, &out_len, src, (uLong)src_len, level);
  return rc == Z_OK ? (size_t)out_len : 0;
}

size_t dn_decompress(const uint8_t* src, size_t src_len, uint8_t* dst,
                     size_t dst_cap) {
  uLongf out_len = (uLongf)dst_cap;
  int rc = uncompress(dst, &out_len, src, (uLong)src_len);
  return rc == Z_OK ? (size_t)out_len : 0;
}

size_t dn_compress_bound(size_t src_len) { return compressBound(src_len); }

// Threaded batch decompress: the read half of the channel codec
// (reference async channel readers, channelbuffernativereader.cpp) —
// every column payload of a partition file inflates in parallel into
// caller-owned buffers (numpy arrays on the Python side, zero copy).
// Returns 0 on success; 1 if any column fails to inflate to exactly
// its declared size.
int32_t dn_decompress_batch(size_t n, const uint8_t** srcs,
                            const uint64_t* src_lens, uint8_t** dsts,
                            const uint64_t* dst_lens) {
  std::vector<int> ok(n, 1);
  std::atomic<size_t> next{0};
  auto work = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n) return;
      uLongf out = (uLongf)dst_lens[i];
      int rc = uncompress(dsts[i], &out, srcs[i], (uLong)src_lens[i]);
      if (rc != Z_OK || out != (uLongf)dst_lens[i]) ok[i] = 0;
    }
  };
  size_t nt = std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > n) nt = n;
  if (nt > 8) nt = 8;
  std::vector<std::thread> pool;
  for (size_t t = 0; t + 1 < nt; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  for (size_t i = 0; i < n; ++i)
    if (!ok[i]) return 1;
  return 0;
}

// --------------------------------------------- prefetch channel reader
// Reads whole files on background threads, keeping up to `depth` blocks
// queued.  Consumer pops blocks in file order.
struct Block {
  std::vector<uint8_t> data;
  int64_t index;
  int32_t error;  // 0 ok, nonzero errno-style
};

struct Channel {
  std::vector<std::string> paths;
  size_t next_read = 0;      // next file index to schedule
  size_t next_deliver = 0;   // next file index to hand out
  size_t depth;
  std::deque<Block> ready;
  std::mutex mu;
  std::condition_variable cv_space;
  std::condition_variable cv_data;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::mutex sched_mu;

  // Current block handed to the consumer (kept alive until next pop).
  Block current;
};

static void read_file(const std::string& path, Block* b) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    b->error = 1;
    return;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  b->data.resize((size_t)sz);
  size_t got = fread(b->data.data(), 1, (size_t)sz, f);
  fclose(f);
  b->error = (got == (size_t)sz) ? 0 : 2;
}

static void worker_loop(Channel* ch) {
  for (;;) {
    size_t idx;
    {
      std::lock_guard<std::mutex> g(ch->sched_mu);
      if (ch->stop.load() || ch->next_read >= ch->paths.size()) return;
      idx = ch->next_read++;
    }
    Block b;
    b.index = (int64_t)idx;
    b.error = 0;
    read_file(ch->paths[idx], &b);
    {
      std::unique_lock<std::mutex> g(ch->mu);
      // Always admit the block the consumer is waiting for, even when
      // the queue is at depth — otherwise out-of-order arrivals fill
      // the queue and deadlock against the in-order consumer.
      ch->cv_space.wait(g, [ch, &b] {
        return ch->stop.load() || ch->ready.size() < ch->depth ||
               (size_t)b.index == ch->next_deliver;
      });
      if (ch->stop.load()) return;
      ch->ready.push_back(std::move(b));
      ch->cv_data.notify_all();
    }
  }
}

void* dn_channel_open(const char** paths, size_t n_paths, size_t depth,
                      size_t n_threads) {
  Channel* ch = new Channel();
  for (size_t i = 0; i < n_paths; ++i) ch->paths.emplace_back(paths[i]);
  ch->depth = depth < 1 ? 1 : depth;
  size_t nt = n_threads < 1 ? 1 : n_threads;
  if (nt > ch->paths.size() && !ch->paths.empty()) nt = ch->paths.size();
  for (size_t i = 0; i < nt; ++i)
    ch->workers.emplace_back(worker_loop, ch);
  return (void*)ch;
}

// Pop the next file (in order). Returns byte length, sets *data to an
// internally-owned buffer valid until the next call; -1 at end of
// channel; -2 on read error.
int64_t dn_channel_next(void* handle, const uint8_t** data) {
  Channel* ch = (Channel*)handle;
  if (ch->next_deliver >= ch->paths.size()) return -1;
  size_t want = ch->next_deliver;
  std::unique_lock<std::mutex> g(ch->mu);
  for (;;) {
    for (auto it = ch->ready.begin(); it != ch->ready.end(); ++it) {
      if ((size_t)it->index == want) {
        ch->current = std::move(*it);
        ch->ready.erase(it);
        ch->cv_space.notify_all();
        ch->next_deliver++;
        if (ch->current.error) return -2;
        *data = ch->current.data.data();
        return (int64_t)ch->current.data.size();
      }
    }
    ch->cv_data.wait(g);
  }
}

void dn_channel_close(void* handle) {
  Channel* ch = (Channel*)handle;
  ch->stop.store(true);
  ch->cv_space.notify_all();
  ch->cv_data.notify_all();
  for (auto& t : ch->workers) t.join();
  delete ch;
}

// ------------------------------------------------- partition file writer
// Native twin of columnar/io.py write_partition_file (format doc there):
// JSON header line + per-column payloads, zlib-compressed per column
// when level >= 0.  Columns are compressed concurrently on a small
// thread pool — the analog of the reference's double-buffered async
// channel writer (channelbuffernativewriter.cpp) plus its WorkQueue
// compute pool (workqueue.h).  Returns 0 on success.
int32_t dn_write_partition(const char* path, size_t n_cols,
                           const char** names, const char** dtypes,
                           const uint8_t** bufs, const uint64_t* lens,
                           uint64_t rows, int32_t level) {
  std::vector<std::vector<uint8_t>> payload(n_cols);
  std::vector<int> ok(n_cols, 1);
  std::atomic<size_t> next{0};
  auto work = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n_cols) return;
      if (level >= 0) {
        uLongf cap = compressBound((uLong)lens[i]);
        payload[i].resize((size_t)cap);
        int rc = compress2(payload[i].data(), &cap, bufs[i], (uLong)lens[i],
                           level);
        if (rc != Z_OK) {
          ok[i] = 0;
          return;
        }
        payload[i].resize((size_t)cap);
      } else {
        payload[i].assign(bufs[i], bufs[i] + lens[i]);
      }
    }
  };
  size_t nt = std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > n_cols) nt = n_cols;
  if (nt > 8) nt = 8;
  std::vector<std::thread> pool;
  for (size_t t = 0; t + 1 < nt; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  for (size_t i = 0; i < n_cols; ++i)
    if (!ok[i]) return 1;

  auto json_escape = [](const char* s) {
    std::string out;
    for (const char* p = s; *p; ++p) {
      unsigned char c = (unsigned char)*p;
      if (c == '"' || c == '\\') {
        out += '\\';
        out += (char)c;
      } else if (c < 0x20) {
        char buf[8];
        snprintf(buf, sizeof(buf), "\\u%04x", c);
        out += buf;
      } else {
        out += (char)c;
      }
    }
    return out;
  };
  std::string header = "{\"rows\": " + std::to_string(rows) +
                       ", \"columns\": [";
  for (size_t i = 0; i < n_cols; ++i) {
    if (i) header += ", ";
    header += "{\"name\": \"" + json_escape(names[i]) + "\", \"dtype\": \"" +
              json_escape(dtypes[i]) + "\", \"rows\": " +
              std::to_string(rows) + ", \"comp\": \"" +
              (level >= 0 ? "zlib" : "none") + "\", \"nbytes\": " +
              std::to_string(payload[i].size()) + "}";
  }
  header += "]}\n";

  FILE* f = fopen(path, "wb");
  if (!f) return 2;
  if (fwrite(header.data(), 1, header.size(), f) != header.size()) {
    fclose(f);
    return 3;
  }
  for (size_t i = 0; i < n_cols; ++i) {
    if (!payload[i].empty() &&
        fwrite(payload[i].data(), 1, payload[i].size(), f) !=
            payload[i].size()) {
      fclose(f);
      return 3;
    }
  }
  fclose(f);
  return 0;
}

// ----------------------------------------------------- in-memory FIFO
// Bounded blocking byte-block queue: the in-process pipelined-stage
// channel (reference RChannelFifo, channelfifo.h:31-136) with latch
// flow control — push blocks when the queue holds `depth` blocks, pop
// blocks until a block or writer close arrives.
struct Fifo {
  std::deque<std::vector<uint8_t>> q;
  size_t depth;
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::vector<uint8_t> current;  // block owned for the consumer
};

void* dn_fifo_create(size_t depth) {
  Fifo* f = new Fifo();
  f->depth = depth < 1 ? 1 : depth;
  return (void*)f;
}

// Returns 0 on success, -1 if the FIFO was already closed.
int32_t dn_fifo_push(void* handle, const uint8_t* data, size_t len) {
  Fifo* f = (Fifo*)handle;
  std::unique_lock<std::mutex> g(f->mu);
  f->cv_space.wait(g, [f] { return f->closed || f->q.size() < f->depth; });
  if (f->closed) return -1;
  f->q.emplace_back(data, data + len);
  f->cv_data.notify_one();
  return 0;
}

// Returns block length (>= 0) with *data set, or -1 at end of stream.
int64_t dn_fifo_pop(void* handle, const uint8_t** data) {
  Fifo* f = (Fifo*)handle;
  std::unique_lock<std::mutex> g(f->mu);
  f->cv_data.wait(g, [f] { return f->closed || !f->q.empty(); });
  if (f->q.empty()) return -1;
  f->current = std::move(f->q.front());
  f->q.pop_front();
  f->cv_space.notify_one();
  *data = f->current.data();
  return (int64_t)f->current.size();
}

void dn_fifo_close(void* handle) {
  Fifo* f = (Fifo*)handle;
  std::lock_guard<std::mutex> g(f->mu);
  f->closed = true;
  f->cv_space.notify_all();
  f->cv_data.notify_all();
}

void dn_fifo_destroy(void* handle) { delete (Fifo*)handle; }

// -------------------------------------------- TLV property wire format
// The reference's tag-length-value property block (GM property/metadata
// serialization, gang/DrProperty.cpp; vertex twin dryadmetadata.cpp):
// each entry is tag(u16 LE) + len(u32 LE) + value bytes.  Used for
// binary mailbox payloads (vertex command/status analogs).
size_t dn_tlv_encoded_size(size_t n, const uint32_t* lens) {
  size_t total = 0;
  for (size_t i = 0; i < n; ++i) total += 6 + (size_t)lens[i];
  return total;
}

size_t dn_tlv_encode(size_t n, const uint16_t* tags, const uint8_t** vals,
                     const uint32_t* lens, uint8_t* out, size_t out_cap) {
  size_t at = 0;
  for (size_t i = 0; i < n; ++i) {
    size_t need = 6 + (size_t)lens[i];
    if (at + need > out_cap) return 0;
    out[at] = (uint8_t)(tags[i] & 0xFF);
    out[at + 1] = (uint8_t)(tags[i] >> 8);
    uint32_t l = lens[i];
    out[at + 2] = (uint8_t)(l & 0xFF);
    out[at + 3] = (uint8_t)((l >> 8) & 0xFF);
    out[at + 4] = (uint8_t)((l >> 16) & 0xFF);
    out[at + 5] = (uint8_t)((l >> 24) & 0xFF);
    memcpy(out + at + 6, vals[i], l);
    at += need;
  }
  return at;
}

// Walk a TLV buffer: fills tags/offsets/lens up to max entries; returns
// the entry count, or (size_t)-1 on malformed input.
size_t dn_tlv_decode(const uint8_t* buf, size_t len, size_t max,
                     uint16_t* tags, uint64_t* offs, uint32_t* lens) {
  size_t at = 0, n = 0;
  while (at < len) {
    if (at + 6 > len || n >= max) return (size_t)-1;
    uint16_t tag = (uint16_t)(buf[at] | (buf[at + 1] << 8));
    uint32_t l = (uint32_t)buf[at + 2] | ((uint32_t)buf[at + 3] << 8) |
                 ((uint32_t)buf[at + 4] << 16) | ((uint32_t)buf[at + 5] << 24);
    if (at + 6 + (size_t)l > len) return (size_t)-1;
    tags[n] = tag;
    offs[n] = (uint64_t)(at + 6);
    lens[n] = l;
    ++n;
    at += 6 + (size_t)l;
  }
  return n;
}

}  // extern "C"
