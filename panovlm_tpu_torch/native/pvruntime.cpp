// panovlm_tpu_torch native runtime: point-cloud readers + threaded prefetch.
//
// The port's own copy of the scan reader of panovlm_tpu/native/pvruntime.cpp
// (the parts the port calls), built with g++ by native/__init__.py into the
// repository's build/ directory and loaded with ctypes.
//
//   pv_read_pcd                : binary/ascii/binary_compressed PCD
//   pv_read_ply                : binary_little_endian / ascii PLY vertices
//   pv_prefetch_*              : N worker threads read whole files into
//                                RAM ahead of the pipeline (replaces the
//                                reference's OpenMP load loops +
//                                mutex/refcount image cache, mvs/MVS.h:89-101)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

// LZF decompression (the codec PCL uses for DATA binary_compressed).
// Stream of control bytes: ctrl < 32 -> literal run of ctrl+1 bytes;
// otherwise a back-reference of (ctrl>>5)+2 bytes (+ extension byte when
// the 3-bit length saturates at 7) at distance ((ctrl&0x1f)<<8)+next+1.
static long lzf_decompress(const unsigned char* in, long in_len,
                           unsigned char* out, long out_len) {
  const unsigned char* ip = in;
  const unsigned char* in_end = in + in_len;
  unsigned char* op = out;
  unsigned char* out_end = out + out_len;
  while (ip < in_end) {
    unsigned int ctrl = *ip++;
    if (ctrl < 32) {
      unsigned int cnt = ctrl + 1;
      if (op + cnt > out_end || ip + cnt > in_end) return -1;
      memcpy(op, ip, cnt);
      op += cnt;
      ip += cnt;
    } else {
      unsigned int len = ctrl >> 5;
      if (len == 7) {
        if (ip >= in_end) return -1;
        len += *ip++;
      }
      if (ip >= in_end) return -1;
      unsigned char* ref = op - (((ctrl & 0x1f) << 8) | *ip++) - 1;
      if (ref < out || op + len + 2 > out_end) return -1;
      for (unsigned int k = 0; k < len + 2; k++) *op++ = *ref++;  // may overlap
    }
  }
  return (long)(op - out);
}

extern "C" {

// ---------------------------------------------------------------------------
// PCD
// ---------------------------------------------------------------------------

// Parses a PCD file. Returns number of points (rows) or -1. Caller frees
// *out with pv_free. Columns returned in *out_cols (3 or 4: x y z [i]).
long pv_read_pcd(const char* path, float** out, int* out_cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  long points = 0;
  int n_fields = 0;
  int mode = -1;  // 0 ascii, 1 binary, 2 binary_compressed
  std::vector<int> sizes, counts;
  std::vector<char> types;
  std::vector<std::string> fields;
  while (fgets(line, sizeof line, f)) {
    if (line[0] == '#') continue;
    char key[64];
    if (sscanf(line, "%63s", key) != 1) continue;
    std::string k(key);
    if (k == "FIELDS") {
      char* p = line + 6;
      char name[64];
      int off = 0;
      while (sscanf(p, "%63s%n", name, &off) == 1) {
        fields.push_back(name);
        p += off;
      }
      n_fields = (int)fields.size();
    } else if (k == "SIZE" || k == "COUNT") {
      char* p = line + k.size();
      int v, off;
      std::vector<int>& dst = (k == "SIZE") ? sizes : counts;
      while (sscanf(p, "%d%n", &v, &off) == 1) { dst.push_back(v); p += off; }
    } else if (k == "TYPE") {
      char* p = line + 4;
      char c;
      int off;
      while (sscanf(p, " %c%n", &c, &off) == 1) { types.push_back(c); p += off; }
    } else if (k == "POINTS") {
      sscanf(line, "POINTS %ld", &points);
    } else if (k == "DATA") {
      char ms[32] = {0};
      sscanf(line, "DATA %31s", ms);
      if (strcmp(ms, "ascii") == 0) mode = 0;
      else if (strcmp(ms, "binary") == 0) mode = 1;
      else if (strcmp(ms, "binary_compressed") == 0) mode = 2;
      break;
    }
  }
  if (points <= 0 || n_fields == 0 || mode < 0) { fclose(f); return -1; }
  if (counts.empty()) counts.assign(n_fields, 1);
  int stride = 0;
  std::vector<int> offs(n_fields);
  for (int i = 0; i < n_fields; i++) {
    offs[i] = stride;
    stride += sizes[i] * counts[i];
  }
  int cols = n_fields < 4 ? n_fields : 4;
  float* data = (float*)malloc(sizeof(float) * points * cols);
  if (mode == 2) {
    // PCL binary_compressed: u32 compressed size, u32 uncompressed size,
    // LZF stream. Decompressed layout is field-major (SoA): for field c,
    // a contiguous block of points * sizes[c]*counts[c] bytes.
    uint32_t comp_sz = 0, uncomp_sz = 0;
    if (fread(&comp_sz, 4, 1, f) != 1 || fread(&uncomp_sz, 4, 1, f) != 1 ||
        uncomp_sz < (uint32_t)(points * stride)) {
      fclose(f); free(data); return -1;
    }
    std::vector<unsigned char> comp(comp_sz), plain(uncomp_sz);
    if (fread(comp.data(), 1, comp_sz, f) != comp_sz ||
        lzf_decompress(comp.data(), comp_sz, plain.data(), uncomp_sz) !=
            (long)uncomp_sz) {
      fclose(f); free(data); return -1;
    }
    long blk = 0;
    for (int c = 0; c < n_fields; c++) {
      int fs = sizes[c] * counts[c];
      if (c < cols) {
        for (long r = 0; r < points; r++) {
          const unsigned char* src = plain.data() + blk + r * fs;
          float v = 0;
          if (types[c] == 'F' && sizes[c] == 4) memcpy(&v, src, 4);
          else if (types[c] == 'F' && sizes[c] == 8) {
            double d; memcpy(&d, src, 8); v = (float)d;
          } else if (types[c] == 'U') {
            uint32_t u = 0; memcpy(&u, src, sizes[c]); v = (float)u;
          } else if (types[c] == 'I') {
            int32_t s = 0; memcpy(&s, src, sizes[c]); v = (float)s;
          }
          data[r * cols + c] = v;
        }
      }
      blk += (long)points * fs;
    }
  } else if (mode == 1) {
    std::vector<unsigned char> buf(stride);
    for (long r = 0; r < points; r++) {
      if (fread(buf.data(), 1, stride, f) != (size_t)stride) { points = r; break; }
      for (int c = 0; c < cols; c++) {
        float v = 0;
        if (types[c] == 'F' && sizes[c] == 4) {
          memcpy(&v, buf.data() + offs[c], 4);
        } else if (types[c] == 'F' && sizes[c] == 8) {
          double d; memcpy(&d, buf.data() + offs[c], 8); v = (float)d;
        } else if (types[c] == 'U') {
          uint32_t u = 0; memcpy(&u, buf.data() + offs[c], sizes[c]); v = (float)u;
        } else if (types[c] == 'I') {
          int32_t s = 0; memcpy(&s, buf.data() + offs[c], sizes[c]); v = (float)s;
        }
        data[r * cols + c] = v;
      }
    }
  } else {
    for (long r = 0; r < points; r++) {
      for (int c = 0; c < n_fields; c++) {
        double v;
        if (fscanf(f, "%lf", &v) != 1) { points = r; goto done; }
        if (c < cols) data[r * cols + c] = (float)v;
      }
    }
  }
done:
  fclose(f);
  *out = data;
  *out_cols = cols;
  return points;
}

// ---------------------------------------------------------------------------
// PLY (vertices only)
// ---------------------------------------------------------------------------

long pv_read_ply(const char* path, float** out, int* out_cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  long n_vertex = 0;
  bool binary = false, big_endian = false;
  std::vector<int> prop_sizes;  // bytes per property
  std::vector<char> prop_types; // 'f','d','u1','i4' simplified: f d b s i
  bool in_vertex = false;
  if (!fgets(line, sizeof line, f) || strncmp(line, "ply", 3) != 0) {
    fclose(f);
    return -1;
  }
  while (fgets(line, sizeof line, f)) {
    if (strncmp(line, "format", 6) == 0) {
      binary = strstr(line, "binary") != nullptr;
      big_endian = strstr(line, "big_endian") != nullptr;
    } else if (strncmp(line, "element vertex", 14) == 0) {
      sscanf(line, "element vertex %ld", &n_vertex);
      in_vertex = true;
    } else if (strncmp(line, "element", 7) == 0) {
      in_vertex = false;
    } else if (in_vertex && strncmp(line, "property", 8) == 0) {
      char t[32], name[64];
      if (sscanf(line, "property %31s %63s", t, name) == 2) {
        if (strcmp(t, "float") == 0 || strcmp(t, "float32") == 0) {
          prop_sizes.push_back(4); prop_types.push_back('f');
        } else if (strcmp(t, "double") == 0) {
          prop_sizes.push_back(8); prop_types.push_back('d');
        } else if (strcmp(t, "uchar") == 0 || strcmp(t, "uint8") == 0 ||
                   strcmp(t, "char") == 0) {
          prop_sizes.push_back(1); prop_types.push_back('b');
        } else if (strcmp(t, "short") == 0 || strcmp(t, "ushort") == 0) {
          prop_sizes.push_back(2); prop_types.push_back('s');
        } else {
          prop_sizes.push_back(4); prop_types.push_back('i');
        }
      }
    } else if (strncmp(line, "end_header", 10) == 0) {
      break;
    }
  }
  if (n_vertex <= 0 || prop_sizes.empty() || big_endian) { fclose(f); return -1; }
  int n_props = (int)prop_sizes.size();
  int cols = n_props < 4 ? n_props : 4;
  int stride = 0;
  std::vector<int> offs(n_props);
  for (int i = 0; i < n_props; i++) { offs[i] = stride; stride += prop_sizes[i]; }
  float* data = (float*)malloc(sizeof(float) * n_vertex * cols);
  if (binary) {
    std::vector<unsigned char> buf(stride);
    for (long r = 0; r < n_vertex; r++) {
      if (fread(buf.data(), 1, stride, f) != (size_t)stride) { n_vertex = r; break; }
      for (int c = 0; c < cols; c++) {
        float v = 0;
        switch (prop_types[c]) {
          case 'f': memcpy(&v, buf.data() + offs[c], 4); break;
          case 'd': { double d; memcpy(&d, buf.data() + offs[c], 8); v = (float)d; } break;
          case 'b': v = (float)buf[offs[c]]; break;
          case 's': { uint16_t u; memcpy(&u, buf.data() + offs[c], 2); v = (float)u; } break;
          default: { int32_t i; memcpy(&i, buf.data() + offs[c], 4); v = (float)i; } break;
        }
        data[r * cols + c] = v;
      }
    }
  } else {
    for (long r = 0; r < n_vertex; r++)
      for (int c = 0; c < n_props; c++) {
        double v;
        if (fscanf(f, "%lf", &v) != 1) { n_vertex = r; goto done2; }
        if (c < cols) data[r * cols + c] = (float)v;
      }
  }
done2:
  fclose(f);
  *out = data;
  *out_cols = cols;
  return n_vertex;
}

void pv_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// threaded prefetch pool
// ---------------------------------------------------------------------------

struct PrefetchJob {
  std::string path;
  long id;
};

struct PrefetchResult {
  long id;
  float* data;
  long rows;
  int cols;
};

struct Prefetcher {
  std::vector<std::thread> workers;
  std::queue<PrefetchJob> jobs;
  std::queue<PrefetchResult> results;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  std::atomic<int> inflight{0};

  void worker() {
    for (;;) {
      PrefetchJob job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || !jobs.empty(); });
        if (stop && jobs.empty()) return;
        job = jobs.front();
        jobs.pop();
      }
      PrefetchResult res{job.id, nullptr, 0, 0};
      const char* p = job.path.c_str();
      size_t len = job.path.size();
      if (len > 4 && strcmp(p + len - 4, ".ply") == 0)
        res.rows = pv_read_ply(p, &res.data, &res.cols);
      else
        res.rows = pv_read_pcd(p, &res.data, &res.cols);
      {
        std::lock_guard<std::mutex> lk(mu);
        results.push(res);
      }
      inflight--;
    }
  }
};

void* pv_prefetch_create(int n_threads) {
  Prefetcher* pf = new Prefetcher();
  for (int i = 0; i < n_threads; i++)
    pf->workers.emplace_back(&Prefetcher::worker, pf);
  return pf;
}

void pv_prefetch_submit(void* h, const char* path, long id) {
  Prefetcher* pf = (Prefetcher*)h;
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->jobs.push({path, id});
    pf->inflight++;
  }
  pf->cv.notify_one();
}

// Polls one finished result. Returns id or -1 if none ready. On success the
// caller takes ownership of *data (pv_free).
long pv_prefetch_poll(void* h, float** data, long* rows, int* cols) {
  Prefetcher* pf = (Prefetcher*)h;
  std::lock_guard<std::mutex> lk(pf->mu);
  if (pf->results.empty()) return -1;
  PrefetchResult r = pf->results.front();
  pf->results.pop();
  *data = r.data;
  *rows = r.rows;
  *cols = r.cols;
  return r.id;
}


void pv_prefetch_destroy(void* h) {
  Prefetcher* pf = (Prefetcher*)h;
  pf->stop = true;
  pf->cv.notify_all();
  for (auto& t : pf->workers) t.join();
  while (!pf->results.empty()) {
    free(pf->results.front().data);
    pf->results.pop();
  }
  delete pf;
}

}  // extern "C"
