// bamcore: native BGZF + BAM record decoder → columnar buffers.
//
// This framework's counterpart of the reference's htslib dependency
// (SURVEY.md §2.1 "Native components"): the reference delegates BGZF
// inflate / record decode to htslib C via pysam; here the same layer is
// a from-scratch C++17 core exposed through a plain C ABI (no pybind11
// in this environment) and consumed by numpy/ctypes
// (svtyper_tpu/bamio/native.py).
//
// Semantics contract: byte-identical columns to the pure-Python decoder
// (svtyper_tpu/bamio/records.py); tests/test_native.py enforces it.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <memory>
#include <list>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>
#include <zlib.h>
#ifdef USE_LIBDEFLATE
#include <libdeflate.h>
#endif

static std::mutex g_err_mu;  // serializes handle error-string writes

// Lightweight perf counters (svt_perf): inflate wall-ns, blocks
// inflated, worker wall-ns, block-cache hits. One steady_clock pair per
// ~64 KiB block / per worker call — negligible overhead, always on.
static std::atomic<int64_t> g_perf_inflate_ns{0}, g_perf_blocks{0},
    g_perf_worker_ns{0}, g_perf_cache_hits{0}, g_perf_inflate_bytes{0},
    g_perf_inflate_cpu_ns{0};

// per-thread CPU time: wall-vs-cpu separates the inflate code's true
// cost from scheduler contention on small hosts (bench roofline frac)
static inline int64_t thread_cpu_ns() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static inline int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Per-thread output of svt_fetch_chunk: the device-chunk layout built
// directly in C++ (columns match evidence/extract.py READS_*/PAIRS_*).
struct ChunkBuf {
  // candidate reads (evidence table, §4.1–4.2 predicates)
  std::vector<int32_t> c_var, c_tid, c_pos, c_end, c_lead, c_sa_tid,
      c_sa_pos, c_sa_end, c_sa_lead;
  std::vector<uint8_t> c_rev, c_mapq, c_lsoft, c_rsoft, c_cova, c_covb,
      c_hassa, c_sarev, c_samapq;
  // self-contained fragment pairs (§4.3)
  std::vector<int32_t> p_var, p_apos, p_aend, p_bpos, p_bend, p_atid,
      p_btid;
  std::vector<int16_t> p_aaln, p_baln, p_alib;
  std::vector<uint8_t> p_arev, p_brev, p_amapq, p_bmapq;
  // compact-wire extras (svt_chunk_export_compact): the §4.1-4.3
  // integer predicates evaluated at emission (numpy twin:
  // evidence/extract.py::compact_chunk — bit-identical by construction)
  std::vector<uint8_t> c_rflags;
  std::vector<int32_t> p_ospan;
  std::vector<uint8_t> p_flags, p_libu8;
  // -w evidence export (svt_set_evidence): EVERY kept row's location,
  // recorded pre-candidate-selection and pre-max_reads truncation so
  // the written read set matches the per-variant oracle gather
  std::vector<int32_t> e_tid, e_pos, e_end, e_flag;
  std::vector<uint64_t> e_vo;

  void clear() {
    c_var.clear(); c_tid.clear(); c_pos.clear(); c_end.clear();
    c_lead.clear(); c_sa_tid.clear(); c_sa_pos.clear(); c_sa_end.clear();
    c_sa_lead.clear();
    c_rev.clear(); c_mapq.clear(); c_lsoft.clear(); c_rsoft.clear();
    c_cova.clear(); c_covb.clear(); c_hassa.clear(); c_sarev.clear();
    c_samapq.clear();
    p_var.clear(); p_apos.clear(); p_aend.clear(); p_bpos.clear();
    p_bend.clear(); p_atid.clear(); p_btid.clear();
    p_aaln.clear(); p_baln.clear(); p_alib.clear();
    p_arev.clear(); p_brev.clear(); p_amapq.clear(); p_bmapq.clear();
    c_rflags.clear();
    p_ospan.clear(); p_flags.clear(); p_libu8.clear();
    e_tid.clear(); e_pos.clear(); e_end.clear(); e_flag.clear();
    e_vo.clear();
  }
  void truncate_cands(size_t n) {
    c_var.resize(n); c_tid.resize(n); c_pos.resize(n); c_end.resize(n);
    c_lead.resize(n); c_sa_tid.resize(n); c_sa_pos.resize(n);
    c_sa_end.resize(n); c_sa_lead.resize(n);
    c_rev.resize(n); c_mapq.resize(n); c_lsoft.resize(n);
    c_rsoft.resize(n); c_cova.resize(n); c_covb.resize(n);
    c_hassa.resize(n); c_sarev.resize(n); c_samapq.resize(n);
    if (c_rflags.size() > n) c_rflags.resize(n);
  }
};

// compact-wire flag bits (mirror evidence/extract.py)
static const uint8_t R_COVHIT = 1, R_CLIPHIT = 2, R_LHIT = 4, R_RHIT = 8,
                     R_PRIMFIRST = 16;
static const uint8_t P_ALT = 1, P_ALTREC = 2;
static const int32_t SPLIT_SLOP = 7;  // extract._SPLIT_SLOP
static const uint8_t LIB_INVALID = 255;

// per-variant predicate context for the compact wire
struct VarPred {
  int64_t tid_a, pos_a, cia0, cia1, tid_b, pos_b, cib0, cib1;
  bool o1, o2, is_del, is_inv;
};

// extract._np_edge_in_window: the split/clip edge lands in a CI window
static inline bool edge_in_window(int64_t pos, int64_t end, int64_t tid,
                                  int64_t bp_tid, int64_t bp_pos,
                                  int64_t ci0, int64_t ci1, bool o_rev) {
  const int64_t edge = o_rev ? pos : end - 1;
  return tid == bp_tid && edge >= bp_pos + ci0 - SPLIT_SLOP &&
         edge <= bp_pos + ci1 + SPLIT_SLOP;
}


// Shared inflated-block cache, one per open BAM handle. Fetch windows
// revisit BGZF blocks constantly — a variant's A/B windows, its mate
// windows, and neighbouring variants all land in the same ~64 KiB
// blocks, and measured redundancy on the bench fixture was ~2.3x the
// file per 1024-variant chunk. Blocks are immutable once inflated, so
// readers hold shared_ptrs and eviction never invalidates an in-use
// buffer. Capacity: SVT_BLOCK_CACHE_MB (default 1024; 0 disables).
// Inflated-block storage WITHOUT value-initialization: a plain
// std::vector<uint8_t>(isize) memsets the 64 KiB block before
// libdeflate overwrites every byte — during a cold pass that growing
// cache already pays the kernel's page-zeroing on first touch, so the
// redundant memset was a full extra pass over the working set
// (measured: inflate CPU-time ran ~4x the bare single-buffer roofline;
// see bench.py inflate_roofline_frac).
template <class T>
struct NoInitAlloc {
  using value_type = T;
  T* allocate(size_t n) { return (T*)::operator new(n * sizeof(T)); }
  void deallocate(T* p, size_t) noexcept { ::operator delete(p); }
  template <class U>
  void construct(U*) noexcept {}  // default-init: no zeroing
  template <class U, class... A>
  void construct(U* p, A&&... a) {
    ::new ((void*)p) U(std::forward<A>(a)...);
  }
  template <class U> struct rebind { using other = NoInitAlloc<U>; };
  bool operator==(const NoInitAlloc&) const noexcept { return true; }
  bool operator!=(const NoInitAlloc&) const noexcept { return false; }
};
using BlockVec = std::vector<uint8_t, NoInitAlloc<uint8_t>>;

// Process-wide cache budget, shared across every open handle's
// BlockCache: each Sample opens its own handle, so a per-handle cap
// would multiply by the sample count and a >=4-sample run could stack
// caches up to the whole RAM/cgroup limit (advisor finding, r4). The
// budget is computed once; each cache's effective cap is
// budget / n_open_caches, re-read at every put so opening a new handle
// lazily shrinks existing caches at their next insert.
static std::atomic<int> g_n_caches{0};

static size_t cache_budget_bytes() {
  static size_t budget = [] {
    // default: a quarter of RAM (cgroup-v2-aware), clamped to
    // [256 MB, 4 GiB] for the whole process. WGS-scale fetch streams
    // carry multi-GB inflated working sets and a too-small cache
    // re-inflates warm passes, but a fixed large default would OOM
    // memory-limited containers. SVT_BLOCK_CACHE_MB overrides (still
    // interpreted PER HANDLE for back-compat with operators who sized
    // it explicitly); 0 disables.
    long ram_mb = 4096;  // probe-failure fallback
    FILE* f = fopen("/proc/meminfo", "r");
    if (f) {
      char key[64];
      long val;
      char unit[16];
      while (fscanf(f, "%63s %ld %15s", key, &val, unit) == 3) {
        if (strcmp(key, "MemTotal:") == 0) {
          ram_mb = val / 1024;
          break;
        }
      }
      fclose(f);
    }
    FILE* g = fopen("/sys/fs/cgroup/memory.max", "r");
    if (g) {
      long long lim;
      if (fscanf(g, "%lld", &lim) == 1 && lim > 0 &&
          lim / (1024 * 1024) < ram_mb)
        ram_mb = (long)(lim / (1024 * 1024));
      fclose(g);
    }
    long mb = ram_mb / 4;
    if (mb > 4096) mb = 4096;
    if (mb < 256) mb = 256;
    return (size_t)mb << 20;
  }();
  return budget;
}

struct BlockCache {
  // O(1) LRU: entries live on an intrusive recency list; get() splices
  // the hit to the front, put() evicts from the back. The previous
  // full-map victim scan per eviction turned O(n^2) once the cache
  // filled (observed 30x per-block slowdown past ~16k resident blocks
  // on a >1 GB working set).
  struct Entry {
    std::shared_ptr<const BlockVec> buf;
    size_t next_co;
    std::list<size_t>::iterator lru_it;
  };
  std::mutex mu;
  std::unordered_map<size_t, Entry> map;
  std::list<size_t> lru;  // front = most recent
  size_t bytes = 0;
  size_t env_cap = 0;   // explicit SVT_BLOCK_CACHE_MB (per handle)
  bool use_env = false;
  bool disabled = false;

  BlockCache() {
    const char* e = getenv("SVT_BLOCK_CACHE_MB");
    if (e) {
      long mb = atol(e);
      if (mb <= 0) {
        disabled = true;
      } else {
        use_env = true;
        env_cap = (size_t)mb << 20;
      }
    }
    g_n_caches.fetch_add(1, std::memory_order_relaxed);
  }
  ~BlockCache() { g_n_caches.fetch_sub(1, std::memory_order_relaxed); }

  size_t cap_now() const {
    if (disabled) return 0;
    if (use_env) return env_cap;
    int n = g_n_caches.load(std::memory_order_relaxed);
    return cache_budget_bytes() / (n > 0 ? (size_t)n : 1);
  }

  bool get(size_t co, std::shared_ptr<const BlockVec>* buf,
           size_t* next_co) {
    if (disabled) return false;
    std::lock_guard<std::mutex> g(mu);
    auto it = map.find(co);
    if (it == map.end()) return false;
    lru.splice(lru.begin(), lru, it->second.lru_it);
    *buf = it->second.buf;
    *next_co = it->second.next_co;
    return true;
  }

  void put(size_t co, std::shared_ptr<const BlockVec> buf,
           size_t next_co) {
    const size_t cap = cap_now();
    if (!cap) return;
    std::lock_guard<std::mutex> g(mu);
    if (map.count(co)) return;
    while (bytes + buf->size() > cap && !map.empty()) {
      const size_t victim_co = lru.back();
      auto v = map.find(victim_co);
      bytes -= v->second.buf->size();
      map.erase(v);
      lru.pop_back();
    }
    if (buf->size() > cap) return;
    bytes += buf->size();
    lru.push_front(co);
    map.emplace(co, Entry{std::move(buf), next_co, lru.begin()});
  }
};

extern "C" {

// ---------------------------------------------------------------- handle

struct SvtBam {
  // whole compressed file, mmap'd read-only (page cache shared with the
  // Python-side mmap — no double-buffering of big BAMs)
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  uint64_t body_voffset = 0;       // first record (set by python)
  std::string error;
  // name tables cached via svt_set_names (read-only afterwards, so the
  // handle is safe to share across decode threads)
  std::vector<std::string> ref_cache, rg_cache;
  std::vector<const char*> ref_ptrs;
  int32_t n_rg_cached = 0;
  // svt_fetch_chunk → svt_chunk_export arena (grow-only per thread slot;
  // one in-flight chunk per handle, like the Python-side _BufSet model)
  std::vector<ChunkBuf> chunk_bufs;
  int32_t want_evidence = 0;  // svt_set_evidence: record kept-row rows
  BlockCache bcache;

  const uint8_t* data() const { return map; }
  size_t size() const { return map_size; }
  ~SvtBam() {
    if (map) munmap(const_cast<uint8_t*>(map), map_size);
  }
};

void* svt_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  auto* h = new SvtBam();
  h->map_size = (size_t)st.st_size;
  if (h->map_size) {
    void* m = mmap(nullptr, h->map_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      close(fd);
      delete h;
      return nullptr;
    }
    h->map = static_cast<const uint8_t*>(m);
  }
  close(fd);
  return h;
}

void svt_close(void* vh) { delete static_cast<SvtBam*>(vh); }

const char* svt_error(void* vh) {
  return static_cast<SvtBam*>(vh)->error.c_str();
}

// ------------------------------------------------------------- stream

static const BlockVec kEmptyBlock;

struct VStream {
  SvtBam* h;
  size_t coffset;
  size_t uoffset;
  bool eof = false;
  // current inflated block: shared with (and kept alive independently
  // of) the handle's BlockCache — streams never mutate a cached block,
  // so any number can decode the same handle concurrently
  std::shared_ptr<const BlockVec> ubp;
  size_t ub_coffset = SIZE_MAX;
  size_t ub_next = 0;
#ifdef USE_LIBDEFLATE
  // reusable decompressor: alloc once per stream, not per block
  struct libdeflate_decompressor* ld = nullptr;
  ~VStream() {
    if (ld) libdeflate_free_decompressor(ld);
  }
#endif

  const BlockVec& ub() const {
    return ubp ? *ubp : kEmptyBlock;
  }

  int inflate_here(size_t co) {
    if (ub_coffset == co) return 0;
    if (h->bcache.get(co, &ubp, &ub_next)) {
      ub_coffset = co;
      g_perf_cache_hits.fetch_add(1, std::memory_order_relaxed);
      return 0;
    }
    const int64_t t0 = now_ns();
    const int64_t c0 = thread_cpu_ns();
    const uint8_t* b = h->data();
    size_t n = h->size();
    if (co + 18 > n) { { std::lock_guard<std::mutex> g(g_err_mu); h->error = "offset past EOF"; } return -1; }
    if (b[co] != 0x1f || b[co + 1] != 0x8b) {
      { std::lock_guard<std::mutex> g(g_err_mu); h->error = "bad gzip magic"; }
      return -1;
    }
    uint16_t xlen;
    memcpy(&xlen, b + co + 10, 2);
    size_t xoff = co + 12, xend = xoff + xlen;
    // bounds guards: a corrupt/truncated block (bit-flipped XLEN,
    // SLEN or BSIZE; download cut mid-block) must produce a
    // controlled error, not a read past the mmap (SIGBUS on the last
    // page) — mirror of svt_inflate_roofline's guards (review, r5)
    if (xend > n) { { std::lock_guard<std::mutex> g(g_err_mu); h->error = "truncated BGZF header"; } return -1; }
    size_t bsize = 0;
    while (xoff + 4 <= xend) {
      uint8_t si1 = b[xoff], si2 = b[xoff + 1];
      uint16_t slen;
      memcpy(&slen, b + xoff + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, b + xoff + 4, 2);
        bsize = (size_t)bs + 1;
      }
      xoff += 4 + slen;
    }
    if (!bsize) { { std::lock_guard<std::mutex> g(g_err_mu); h->error = "missing BC subfield"; } return -1; }
    if (co + bsize > n || co + bsize < xend + 8) {
      { std::lock_guard<std::mutex> g(g_err_mu); h->error = "corrupt BGZF BSIZE"; }
      return -1;
    }
    uint32_t isize;
    memcpy(&isize, b + co + bsize - 4, 4);
    auto nb = std::make_shared<BlockVec>(isize);
#ifdef USE_LIBDEFLATE
    if (isize) {
      if (!ld) ld = libdeflate_alloc_decompressor();
      size_t actual = 0;
      enum libdeflate_result rc = libdeflate_deflate_decompress(
          ld, b + xend, co + bsize - 8 - xend, nb->data(), isize, &actual);
      if (rc != LIBDEFLATE_SUCCESS || actual != isize) {
        { std::lock_guard<std::mutex> g(g_err_mu); h->error = "inflate failed"; }
        return -1;
      }
    }
#else
    if (isize) {
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) {
        { std::lock_guard<std::mutex> g(g_err_mu); h->error = "inflateInit"; }
        return -1;
      }
      zs.next_in = const_cast<uint8_t*>(b) + xend;
      zs.avail_in = (uInt)(co + bsize - 8 - xend);
      zs.next_out = nb->data();
      zs.avail_out = isize;
      int rc = inflate(&zs, Z_FINISH);
      // total_out must equal ISIZE: with no-init block buffers a
      // short-but-valid stream would otherwise leave uninitialized
      // heap bytes for the record parser (review, r5; the libdeflate
      // branch's actual != isize check is the twin)
      bool ok = rc == Z_STREAM_END && zs.total_out == (uLong)isize;
      inflateEnd(&zs);
      if (!ok) { { std::lock_guard<std::mutex> g(g_err_mu); h->error = "inflate failed"; } return -1; }
    }
#endif
    ubp = nb;
    h->bcache.put(co, std::move(nb), co + bsize);
    ub_coffset = co;
    ub_next = co + bsize;
    g_perf_inflate_ns.fetch_add(now_ns() - t0, std::memory_order_relaxed);
    g_perf_inflate_cpu_ns.fetch_add(thread_cpu_ns() - c0,
                                    std::memory_order_relaxed);
    g_perf_blocks.fetch_add(1, std::memory_order_relaxed);
    g_perf_inflate_bytes.fetch_add((int64_t)isize, std::memory_order_relaxed);
    return 0;
  }

  bool ensure() {  // make current block available; advance past empties
    while (true) {
      if (coffset >= h->size()) { eof = true; return false; }
      if (inflate_here(coffset) != 0) { eof = true; return false; }
      if (uoffset < ub().size()) return true;
      // block exhausted (or empty EOF sentinel) → next block
      coffset = ub_next;
      uoffset = 0;
      if (ub().empty() && coffset >= h->size()) {
        eof = true;
        return false;
      }
    }
  }

  uint64_t voffset() const { return ((uint64_t)coffset << 16) | uoffset; }

  // read exactly n bytes into dst; false on EOF
  bool read(uint8_t* dst, size_t n) {
    while (n) {
      if (!ensure()) return false;
      size_t avail = ub().size() - uoffset;
      size_t take = avail < n ? avail : n;
      memcpy(dst, ub().data() + uoffset, take);
      uoffset += take;
      dst += take;
      n -= take;
    }
    return true;
  }

  // advance n bytes without copying (skipped record payloads)
  bool skip(size_t n) {
    while (n) {
      if (!ensure()) return false;
      size_t avail = ub().size() - uoffset;
      size_t take = avail < n ? avail : n;
      uoffset += take;
      n -= take;
    }
    return true;
  }
};

// ------------------------------------------------------------- decode

// FNV-1a 64 (matches svtyper_tpu.bamio.columns.qname_hash_bytes)
static inline uint64_t fnv1a(const uint8_t* p, size_t n) {
  uint64_t hh = 0xCBF29CE484222325ULL;
  for (size_t i = 0; i < n; i++) {
    hh ^= p[i];
    hh *= 0x100000001B3ULL;
  }
  return hh;
}

// out columns struct-of-arrays; capacities enforced by caller
struct Cols {
  int32_t *tid, *pos, *ref_end;
  uint16_t* flag;
  uint8_t* mapq;
  int32_t *tlen, *mate_tid, *mate_pos;
  uint64_t* qname_hash;
  int32_t *left_soft, *right_soft, *ref_aln_len, *query_len, *lead_clip_q,
      *lib_id;
  uint8_t* has_sa;
  int32_t *sa_tid, *sa_pos, *sa_end;
  uint8_t* sa_is_reverse;
  uint8_t* sa_mapq;
  int32_t* sa_lead_clip_q;
  uint64_t* voffset;
  uint8_t *cov_a, *cov_b;  // fetch_many coverage predicates (§4.1)
  int64_t* blk_off;   // capacity n+1
  int32_t *blk_start, *blk_end;  // capacity blk_cap
};

static const uint32_t OP_CQ = 0x193;  // query-consuming ops bitmask MIS=X: 0,1,4,7,8
static const uint32_t OP_CR = 0x18d;  // ref: MDN=X: 0,2,3,7,8
static const uint32_t OP_AL = 0x181;  // aligned: M,=,X

struct SaInfo {
  int32_t tid = -1, pos = -1, end = -1, lead = 0;
  uint8_t rev = 0, mapq = 0;
  bool present = false;
};

// SAM spec §4.2.2 long-CIGAR form: a record with >65535 ops stores a
// kSmN placeholder (k = l_seq, m = reference span) in the cigar field
// and the true op array (same u32 len<<4|op encoding) in a CG:B,I aux
// tag. Returns the op array + count when the placeholder matches and
// the tag exists; nullptr otherwise (use the in-record cigar).
static const uint8_t* cg_long_cigar(const uint8_t* cig, uint32_t n_cig,
                                    int32_t l_seq, const uint8_t* aux,
                                    size_t aux_len, uint32_t* out_n) {
  if (n_cig != 2 || l_seq <= 0) return nullptr;
  uint32_t c0, c1;
  memcpy(&c0, cig, 4);
  memcpy(&c1, cig + 4, 4);
  if ((c0 & 0xF) != 4 || (c1 & 0xF) != 3) return nullptr;
  if ((int32_t)(c0 >> 4) != l_seq) return nullptr;
  size_t p = 0;
  while (p + 3 <= aux_len) {
    uint8_t t0 = aux[p], t1 = aux[p + 1], typ = aux[p + 2];
    p += 3;
    switch (typ) {
      case 'A': case 'c': case 'C': p += 1; break;
      case 's': case 'S': p += 2; break;
      case 'i': case 'I': case 'f': p += 4; break;
      case 'Z': case 'H': {
        while (p < aux_len && aux[p]) p++;
        p++;
        break;
      }
      case 'B': {
        if (p + 5 > aux_len) return nullptr;
        uint8_t sub = aux[p];
        uint32_t cnt;
        memcpy(&cnt, aux + p + 1, 4);
        size_t esz = (sub == 'c' || sub == 'C' || sub == 'A') ? 1
                     : (sub == 's' || sub == 'S')             ? 2
                                                              : 4;
        if (t0 == 'C' && t1 == 'G' && sub == 'I') {
          if (p + 5 + 4ull * cnt > aux_len) return nullptr;
          *out_n = cnt;
          return aux + p + 5;
        }
        p += 5 + (size_t)cnt * esz;
        break;
      }
      default:
        return nullptr;
    }
  }
  return nullptr;
}

// parse first entry of SA:Z: value (rname,pos,strand,cigar,mapq,nm;)
static void parse_sa(const uint8_t* s, const uint8_t* send,
                     const char* const* ref_names, int n_ref, SaInfo* out) {
  // rname
  const uint8_t* p = s;
  const uint8_t* q = p;
  while (q < send && *q != ',') q++;
  if (q >= send) return;
  std::string rname((const char*)p, (size_t)(q - p));
  int tid = -1;
  for (int i = 0; i < n_ref; i++) {
    if (rname == ref_names[i]) { tid = i; break; }
  }
  p = q + 1;
  long pos = 0;
  while (p < send && *p >= '0' && *p <= '9') pos = pos * 10 + (*p++ - '0');
  if (p >= send || *p != ',') return;
  p++;
  if (p >= send) return;
  uint8_t rev = (*p == '-');
  p++;
  if (p >= send || *p != ',') return;
  p++;
  // cigar
  int32_t ref_len = 0, lclip = 0, rclip = 0, pend_clip = 0;
  bool seen_core = false;
  long num = 0;
  while (p < send && *p != ',') {
    char c = (char)*p++;
    if (c >= '0' && c <= '9') {
      num = num * 10 + (c - '0');
      continue;
    }
    int op;
    switch (c) {
      case 'M': op = 0; break;
      case 'I': op = 1; break;
      case 'D': op = 2; break;
      case 'N': op = 3; break;
      case 'S': op = 4; break;
      case 'H': op = 5; break;
      case 'P': op = 6; break;
      case '=': op = 7; break;
      case 'X': op = 8; break;
      default: return;
    }
    if (op == 4 || op == 5) {
      if (!seen_core) lclip += (int32_t)num;
      pend_clip += (int32_t)num;  // trailing stack: see walk comment
    } else {
      seen_core = true;  // any non-clip (incl. P) ends both stacks
      pend_clip = 0;
      if (OP_CR & (1u << op)) ref_len += (int32_t)num;
    }
    num = 0;
  }
  rclip = pend_clip;
  long mq = 0;
  if (p < send && *p == ',') {
    p++;
    while (p < send && *p >= '0' && *p <= '9') mq = mq * 10 + (*p++ - '0');
  }
  out->present = true;
  out->tid = tid;
  out->pos = (int32_t)(pos - 1);
  out->end = (int32_t)(pos - 1 + ref_len);
  out->rev = rev;
  out->mapq = (uint8_t)mq;
  out->lead = rev ? rclip : lclip;
}

static void parse_sa(const uint8_t* s, const uint8_t* send,
                     const char* const* ref_names, int n_ref, SaInfo* out);

// parse_sa against the handle's cached reference-name table
static void parse_sa_cached(SvtBam* h, const uint8_t* s, const uint8_t* send,
                            SaInfo* out) {
  parse_sa(s, send, h->ref_ptrs.data(), (int)h->ref_ptrs.size(), out);
}

// Decode records; returns count, or -1 on error, -2 when capacity hit
// (caller re-invokes with bigger buffers from the returned resume state).
long svt_decode(void* vh,
                uint64_t start_voffset,
                uint64_t stop_voffset,   // UINT64_MAX = none
                int64_t max_records,     // -1 = none
                int32_t region_tid, int64_t region_start, int64_t region_end,
                int32_t keep_unmapped,
                const char* const* ref_names, int32_t n_ref,
                const char* const* rg_names, int32_t n_rg,
                int64_t cap_rows, int64_t cap_blocks,
                Cols* out,
                uint64_t* out_next_voffset,
                int64_t* out_seen,
                int64_t* out_rows) {
  SvtBam* h = static_cast<SvtBam*>(vh);
  VStream vs{h, (size_t)(start_voffset >> 16), (size_t)(start_voffset & 0xFFFF)};
  long n = 0;
  int64_t blk_n = 0;
  int64_t seen = 0;
  out->blk_off[0] = 0;
  std::vector<uint8_t> rec;
  std::vector<int32_t> bstart, bend;
  bool have_region = region_tid >= 0;
  while (true) {
    if (!vs.ensure()) break;
    uint64_t vo = vs.voffset();
    if (stop_voffset != UINT64_MAX && vo >= stop_voffset) break;
    if (max_records >= 0 && seen >= max_records) break;
    uint8_t szb[4];
    if (!vs.read(szb, 4)) break;
    int32_t block_size;
    memcpy(&block_size, szb, 4);
    if (block_size < 32) { { std::lock_guard<std::mutex> g(g_err_mu); h->error = "bad record size"; } return -1; }
    rec.resize((size_t)block_size);
    if (!vs.read(rec.data(), (size_t)block_size)) {
      { std::lock_guard<std::mutex> g(g_err_mu); h->error = "truncated record"; }
      return -1;
    }
    int32_t tid, pos, l_seq, mtid, mpos, tlen;
    memcpy(&tid, rec.data(), 4);
    memcpy(&pos, rec.data() + 4, 4);
    uint8_t l_rn = rec[8], mapq = rec[9];
    uint16_t n_cig, flag;
    memcpy(&n_cig, rec.data() + 12, 2);
    memcpy(&flag, rec.data() + 14, 2);
    memcpy(&l_seq, rec.data() + 16, 4);
    memcpy(&mtid, rec.data() + 20, 4);
    memcpy(&mpos, rec.data() + 24, 4);
    memcpy(&tlen, rec.data() + 28, 4);
    seen++;
    if (have_region && (tid != region_tid || pos >= region_end)) break;
    if ((flag & 0x4) && !keep_unmapped) continue;

    size_t off = 32;
    const uint8_t* qname = rec.data() + off;
    size_t qname_len = l_rn ? (size_t)l_rn - 1 : 0;
    off += l_rn;

    // cigar walk (CG-aware: >65535-op records walk the CG:B,I array)
    const uint8_t* eff_ops = rec.data() + off;
    uint32_t eff_n = n_cig;
    {
      const size_t aux_off =
          off + 4ull * n_cig + ((size_t)l_seq + 1) / 2 + (size_t)l_seq;
      if (n_cig == 2 && aux_off <= rec.size()) {
        uint32_t cgn = 0;
        const uint8_t* cg =
            cg_long_cigar(eff_ops, n_cig, l_seq, rec.data() + aux_off,
                          rec.size() - aux_off, &cgn);
        if (cg) { eff_ops = cg; eff_n = cgn; }
      }
    }
    int32_t cur = pos, ref_aln = 0, qlen = 0;
    int32_t lsoft = 0, rsoft = 0, lclip = 0, rclip = 0;
    bstart.clear();
    bend.clear();
    int32_t open_start = INT32_MIN;
    // leading clips
    {
      // first pass for features
      size_t coff = 0;
      bool leading = true;
      int32_t trail_clip = 0, trail_soft = 0;
      for (uint32_t i = 0; i < eff_n; i++) {
        uint32_t v;
        memcpy(&v, eff_ops + coff, 4);
        coff += 4;
        uint32_t op = v & 0xF, len = v >> 4;
        bool is_clip = (op == 4 || op == 5);
        if (is_clip) {
          if (leading) {
            lclip += (int32_t)len;
            if (op == 4) lsoft += (int32_t)len;
          }
          // trailing stack accumulates over EVERY clip op and resets
          // at any non-clip (incl. P): an all-clip CIGAR is seen by
          // BOTH sides, matching CigarFeatures' independent end
          // scans (fuzz-found divergence, r4)
          trail_clip += (int32_t)len;
          if (op == 4) trail_soft += (int32_t)len;
        } else {
          leading = false;
          trail_clip = 0;
          trail_soft = 0;
        }
        if (OP_CQ & (1u << op)) qlen += (int32_t)len;
        if (OP_AL & (1u << op)) {
          ref_aln += (int32_t)len;
          if (open_start == INT32_MIN) open_start = cur;
          cur += (int32_t)len;
        } else if (OP_CR & (1u << op)) {
          if (open_start != INT32_MIN) {
            bstart.push_back(open_start);
            bend.push_back(cur);
            open_start = INT32_MIN;
          }
          cur += (int32_t)len;
        }
      }
      rclip = trail_clip;
      rsoft = trail_soft;
    }
    if (open_start != INT32_MIN) {
      bstart.push_back(open_start);
      bend.push_back(cur);
    }
    int32_t ref_end = cur;
    off += 4ull * n_cig;
    if (have_region && ref_end <= region_start) continue;
    off += ((size_t)l_seq + 1) / 2 + (size_t)l_seq;

    // aux tags: RG (Z), SA (Z)
    int32_t lib = -1;
    SaInfo sa;
    {
      size_t p = off, end_ = rec.size();
      bool got_rg = false, got_sa = false;
      while (p + 3 <= end_ && !(got_rg && got_sa)) {
        uint8_t t0 = rec[p], t1 = rec[p + 1], typ = rec[p + 2];
        p += 3;
        switch (typ) {
          case 'A': case 'c': case 'C': p += 1; break;
          case 's': case 'S': p += 2; break;
          case 'i': case 'I': case 'f': p += 4; break;
          case 'Z': case 'H': {
            size_t z = p;
            while (z < end_ && rec[z]) z++;
            if (t0 == 'R' && t1 == 'G' && typ == 'Z') {
              got_rg = true;
              std::string val((const char*)rec.data() + p, z - p);
              for (int32_t r = 0; r < n_rg; r++) {
                if (val == rg_names[r]) { lib = r; break; }
              }
            } else if (t0 == 'S' && t1 == 'A' && typ == 'Z') {
              got_sa = true;
              const uint8_t* s = rec.data() + p;
              const uint8_t* send = rec.data() + z;
              const uint8_t* semi = s;
              while (semi < send && *semi != ';') semi++;
              parse_sa(s, semi, ref_names, n_ref, &sa);
            }
            p = z + 1;
            break;
          }
          case 'B': {
            if (p + 5 > end_) { p = end_; break; }
            uint8_t sub = rec[p];
            uint32_t cnt;
            memcpy(&cnt, rec.data() + p + 1, 4);
            size_t esz = (sub == 'c' || sub == 'C' || sub == 'A') ? 1
                         : (sub == 's' || sub == 'S')             ? 2
                                                                  : 4;
            p += 5 + (size_t)cnt * esz;
            break;
          }
          default:
            p = end_;  // unknown tag type: bail on tag scan
        }
      }
    }

    if (n >= cap_rows || blk_n + (int64_t)bstart.size() > cap_blocks) {
      *out_next_voffset = vo;
      *out_seen = seen - 1;  // this record not consumed
      *out_rows = n;
      return -2;
    }

    bool rev = (flag & 0x10) != 0;
    out->tid[n] = tid;
    out->pos[n] = pos;
    out->ref_end[n] = ref_end;
    out->flag[n] = flag;
    out->mapq[n] = mapq;
    out->tlen[n] = tlen;
    out->mate_tid[n] = mtid;
    out->mate_pos[n] = mpos;
    out->qname_hash[n] = fnv1a(qname, qname_len);
    out->left_soft[n] = lsoft;
    out->right_soft[n] = rsoft;
    out->ref_aln_len[n] = ref_aln;
    out->query_len[n] = qlen ? qlen : l_seq;
    out->lead_clip_q[n] = rev ? rclip : lclip;
    out->lib_id[n] = lib;
    out->has_sa[n] = sa.present ? 1 : 0;
    out->sa_tid[n] = sa.present ? sa.tid : -1;
    out->sa_pos[n] = sa.present ? sa.pos : -1;
    out->sa_end[n] = sa.present ? sa.end : -1;
    out->sa_is_reverse[n] = sa.present ? sa.rev : 0;
    out->sa_mapq[n] = sa.present ? sa.mapq : 0;
    out->sa_lead_clip_q[n] = sa.present ? sa.lead : 0;
    out->voffset[n] = vo;
    out->cov_a[n] = 0;
    out->cov_b[n] = 0;
    for (size_t i = 0; i < bstart.size(); i++) {
      out->blk_start[blk_n + (int64_t)i] = bstart[i];
      out->blk_end[blk_n + (int64_t)i] = bend[i];
    }
    blk_n += (int64_t)bstart.size();
    out->blk_off[n + 1] = blk_n;
    n++;
  }
  // normalize the resume position to a block start when at a boundary
  *out_next_voffset = (!vs.eof && vs.ensure()) ? vs.voffset() : UINT64_MAX;
  *out_seen = seen;
  *out_rows = n;
  return n;
}

// Batched fetch: decode many (region × chunk-range) queries in ONE call,
// tagging every row with its query id. This is the host hot path for
// chunked genotyping (svtyper_tpu/evidence/extract.py): it replaces
// thousands of per-window Python→ctypes round trips per variant chunk.
//
// ranges are flat [beg,end) voffset pairs; query q owns
// ranges[range_off[q] .. range_off[q+1]). Returns rows, or -1 on error,
// -2 when capacity was hit (resume via out_state = {query, range, voffset}).
long svt_fetch_many(void* vh,
                    int64_t n_queries,
                    const int64_t* region_tid,
                    const int64_t* region_start,
                    const int64_t* region_end,
                    const int64_t* range_off,
                    const uint64_t* range_beg,
                    const uint64_t* range_end_,
                    // in-core filters + derived features (all nullable):
                    // drop_flags: records with (flag & drop_flags) skipped
                    // before the CIGAR walk; rg_keep/rg_to_lib: [n_rg+1]
                    // tables (slot n_rg = no-RG), rows with !rg_keep
                    // dropped and lib_id emitted already remapped;
                    // cov_*: per-query breakpoint coords for the §4.1
                    // aligned-coverage predicate, computed inline during
                    // the CIGAR walk into out->cov_a/cov_b.
                    int32_t drop_flags,
                    const uint8_t* rg_keep,
                    const int32_t* rg_to_lib,
                    int32_t n_rg_tab,
                    const int64_t* cov_tid_a, const int64_t* cov_pos_a,
                    const int64_t* cov_tid_b, const int64_t* cov_pos_b,
                    int32_t min_aligned,
                    int32_t want_blocks,
                    // resume state (query_idx, range_idx, voffset); pass
                    // {0,0,UINT64_MAX} to start fresh
                    int64_t* io_query, int64_t* io_range, uint64_t* io_voffset,
                    int64_t cap_rows, int64_t cap_blocks,
                    Cols* out, int32_t* out_query_id, int64_t* out_rows,
                    int64_t* out_scanned) {
  SvtBam* h = static_cast<SvtBam*>(vh);
  long n = 0;
  int64_t blk_n = 0;
  int64_t scanned = 0;
  out->blk_off[0] = 0;
  std::vector<uint8_t> rec, aux;
  std::vector<int32_t> bstart, bend;
  const bool do_cov = cov_pos_a != nullptr;
  VStream vs{h, 0, 0};  // one stream: scratch block survives across ranges
  for (int64_t q = *io_query; q < n_queries; q++) {
    int32_t rtid = (int32_t)region_tid[q];
    int64_t rlo = region_start[q], rhi = region_end[q];
    // §4.1 coverage windows for this query's variant
    int64_t ca_tid = -1, ca_lo = 0, ca_hi = 0;
    int64_t cb_tid = -1, cb_lo = 0, cb_hi = 0;
    if (do_cov) {
      ca_tid = cov_tid_a[q];
      ca_lo = cov_pos_a[q] - min_aligned + 1;
      ca_hi = cov_pos_a[q] + min_aligned + 1;
      cb_tid = cov_tid_b[q];
      cb_lo = cov_pos_b[q] - min_aligned + 1;
      cb_hi = cov_pos_b[q] + min_aligned + 1;
    }
    for (int64_t r = (q == *io_query ? *io_range : range_off[q]);
         r < range_off[q + 1]; r++) {
      uint64_t vo0 = range_beg[r];
      if (q == *io_query && r == *io_range && *io_voffset != UINT64_MAX)
        vo0 = *io_voffset;  // resuming mid-range
      vs.coffset = (size_t)(vo0 >> 16);
      vs.uoffset = (size_t)(vo0 & 0xFFFF);
      vs.eof = false;
      uint64_t stop = range_end_[r];
      while (true) {
        if (!vs.ensure()) break;
        uint64_t vo = vs.voffset();
        if (vo >= stop) break;
        uint8_t szb[4];
        if (!vs.read(szb, 4)) break;
        int32_t block_size;
        memcpy(&block_size, szb, 4);
        if (block_size < 32) { { std::lock_guard<std::mutex> g(g_err_mu); h->error = "bad record size"; } return -1; }
        // fixed header only; payload is consumed lazily so skipped
        // records (flag filter, outside-window) cost no memcpy of
        // qname/cigar/seq/qual — the bulk of every record
        uint8_t hdr[32];
        if (!vs.read(hdr, 32)) {
          { std::lock_guard<std::mutex> g(g_err_mu); h->error = "truncated record"; }
          return -1;
        }
        size_t rest = (size_t)block_size - 32;
        int32_t tid, pos, l_seq, mtid, mpos, tlen;
        memcpy(&tid, hdr, 4);
        memcpy(&pos, hdr + 4, 4);
        uint8_t l_rn = hdr[8], mapq = hdr[9];
        uint16_t n_cig, flag;
        memcpy(&n_cig, hdr + 12, 2);
        memcpy(&flag, hdr + 14, 2);
        memcpy(&l_seq, hdr + 16, 4);
        memcpy(&mtid, hdr + 20, 4);
        memcpy(&mpos, hdr + 24, 4);
        memcpy(&tlen, hdr + 28, 4);
        scanned++;
        if (tid != rtid || pos >= rhi) break;  // coordinate-sorted
        if ((flag & 0x4) || (flag & drop_flags)) {  // unmapped / filtered
          if (!vs.skip(rest)) break;
          continue;
        }
        size_t head_len = (size_t)l_rn + 4ull * n_cig;
        size_t sq_len = ((size_t)l_seq + 1) / 2 + (size_t)l_seq;
        if (head_len + sq_len > rest) {
          { std::lock_guard<std::mutex> g(g_err_mu); h->error = "bad record layout"; }
          return -1;
        }
        rec.resize(head_len);
        if (!vs.read(rec.data(), head_len)) {
          { std::lock_guard<std::mutex> g(g_err_mu); h->error = "truncated record"; }
          return -1;
        }
        rest -= head_len;

        // lean refspan scan: BAI linear-index granularity is 16kb, so
        // for narrow windows most scanned records lie entirely left of
        // the window — reject them before the full feature walk (clips,
        // coverage, blocks) and before touching seq/aux
        {
          int64_t span = 0;
          size_t coff = l_rn;
          for (uint16_t i = 0; i < n_cig; i++) {
            uint32_t v;
            memcpy(&v, rec.data() + coff, 4);
            coff += 4;
            if (OP_CR & (1u << (v & 0xF))) span += (int64_t)(v >> 4);
          }
          if (pos + span <= rlo) {
            if (!vs.skip(rest)) break;
            continue;
          }
        }

        const uint8_t* qname = rec.data();
        size_t qname_len = l_rn ? (size_t)l_rn - 1 : 0;
        size_t off = l_rn;

        // CG-aware: a kSmN placeholder (possible >65535-op record)
        // forces the seq skip + aux read EARLY so the true op array
        // (CG:B,I) can drive the feature walk below
        const uint8_t* eff_ops = rec.data() + off;
        uint32_t eff_n = n_cig;
        bool aux_loaded = false;
        if (n_cig == 2) {
          uint32_t c0, c1;
          memcpy(&c0, rec.data() + off, 4);
          memcpy(&c1, rec.data() + off + 4, 4);
          if ((c0 & 0xF) == 4 && (c1 & 0xF) == 3 &&
              (int32_t)(c0 >> 4) == l_seq) {
            if (!vs.skip(sq_len)) break;
            rest -= sq_len;
            aux.resize(rest);
            if (rest && !vs.read(aux.data(), rest)) {
              { std::lock_guard<std::mutex> g(g_err_mu); h->error = "truncated record"; }
              return -1;
            }
            aux_loaded = true;
            uint32_t cgn = 0;
            const uint8_t* cg = cg_long_cigar(
                rec.data() + off, n_cig, l_seq, aux.data(), aux.size(),
                &cgn);
            if (cg) { eff_ops = cg; eff_n = cgn; }
          }
        }

        int32_t cur = pos, ref_aln = 0, qlen = 0;
        int32_t lsoft = 0, rsoft = 0, lclip = 0, rclip = 0;
        int64_t cov_acc_a = 0, cov_acc_b = 0;
        bstart.clear();
        bend.clear();
        int32_t open_start = INT32_MIN;
        {
          size_t coff = 0;
          bool leading = true;
          int32_t trail_clip = 0, trail_soft = 0;
          for (uint32_t i = 0; i < eff_n; i++) {
            uint32_t v;
            memcpy(&v, eff_ops + coff, 4);
            coff += 4;
            uint32_t op = v & 0xF, len = v >> 4;
            bool is_clip = (op == 4 || op == 5);
            if (is_clip) {
              if (leading) {
                lclip += (int32_t)len;
                if (op == 4) lsoft += (int32_t)len;
              }
              // trailing stack accumulates over EVERY clip op and resets
              // at any non-clip (incl. P): an all-clip CIGAR is seen by
              // BOTH sides, matching CigarFeatures' independent end
              // scans (fuzz-found divergence, r4)
              trail_clip += (int32_t)len;
              if (op == 4) trail_soft += (int32_t)len;
            } else {
              leading = false;
              trail_clip = 0;
              trail_soft = 0;
            }
            if (OP_CQ & (1u << op)) qlen += (int32_t)len;
            if (OP_AL & (1u << op)) {
              ref_aln += (int32_t)len;
              if (do_cov) {
                int64_t s = cur, e = cur + (int64_t)len;
                int64_t oa = (e < ca_hi ? e : ca_hi) - (s > ca_lo ? s : ca_lo);
                if (oa > 0) cov_acc_a += oa;
                int64_t ob = (e < cb_hi ? e : cb_hi) - (s > cb_lo ? s : cb_lo);
                if (ob > 0) cov_acc_b += ob;
              }
              if (want_blocks && open_start == INT32_MIN) open_start = cur;
              cur += (int32_t)len;
            } else if (OP_CR & (1u << op)) {
              if (want_blocks && open_start != INT32_MIN) {
                bstart.push_back(open_start);
                bend.push_back(cur);
                open_start = INT32_MIN;
              }
              cur += (int32_t)len;
            }
          }
          rclip = trail_clip;
          rsoft = trail_soft;
        }
        if (want_blocks && open_start != INT32_MIN) {
          bstart.push_back(open_start);
          bend.push_back(cur);
        }
        int32_t ref_end = cur;
        if (ref_end <= rlo) {
          if (!aux_loaded && !vs.skip(rest)) break;
          continue;
        }
        if (!aux_loaded) {
          if (!vs.skip(sq_len)) break;  // seq + qual never copied
          rest -= sq_len;
          aux.resize(rest);
          if (rest && !vs.read(aux.data(), rest)) {
            { std::lock_guard<std::mutex> g(g_err_mu); h->error = "truncated record"; }
            return -1;
          }
        }

        int32_t lib = -1;
        SaInfo sa;
        {
          size_t p = 0, end_ = aux.size();
          bool got_rg = false, got_sa = false;
          while (p + 3 <= end_ && !(got_rg && got_sa)) {
            uint8_t t0 = aux[p], t1 = aux[p + 1], typ = aux[p + 2];
            p += 3;
            switch (typ) {
              case 'A': case 'c': case 'C': p += 1; break;
              case 's': case 'S': p += 2; break;
              case 'i': case 'I': case 'f': p += 4; break;
              case 'Z': case 'H': {
                size_t z = p;
                while (z < end_ && aux[z]) z++;
                if (t0 == 'R' && t1 == 'G' && typ == 'Z') {
                  got_rg = true;
                  std::string val((const char*)aux.data() + p, z - p);
                  for (int32_t g = 0; g < h->n_rg_cached; g++) {
                    if (val == h->rg_cache[g]) { lib = g; break; }
                  }
                } else if (t0 == 'S' && t1 == 'A' && typ == 'Z') {
                  got_sa = true;
                  const uint8_t* s = aux.data() + p;
                  const uint8_t* send = aux.data() + z;
                  const uint8_t* semi = s;
                  while (semi < send && *semi != ';') semi++;
                  parse_sa_cached(h, s, semi, &sa);
                }
                p = z + 1;
                break;
              }
              case 'B': {
                if (p + 5 > end_) { p = end_; break; }
                uint8_t sub = aux[p];
                uint32_t cnt;
                memcpy(&cnt, aux.data() + p + 1, 4);
                size_t esz = (sub == 'c' || sub == 'C' || sub == 'A') ? 1
                             : (sub == 's' || sub == 'S')             ? 2
                                                                      : 4;
                p += 5 + (size_t)cnt * esz;
                break;
              }
              default:
                p = end_;
            }
          }
        }

        // RG keep/remap tables (slot n_rg_tab = reads with no RG tag)
        if (rg_keep || rg_to_lib) {
          int32_t slot = (lib >= 0 && lib < n_rg_tab) ? lib : n_rg_tab;
          if (rg_keep && !rg_keep[slot]) continue;
          if (rg_to_lib) lib = rg_to_lib[slot];
        }

        if (n >= cap_rows || blk_n + (int64_t)bstart.size() > cap_blocks) {
          *io_query = q;
          *io_range = r;
          *io_voffset = vo;
          *out_rows = n;
          *out_scanned = scanned;
          return -2;
        }
        bool rev = (flag & 0x10) != 0;
        out->tid[n] = tid;
        out->pos[n] = pos;
        out->ref_end[n] = ref_end;
        out->flag[n] = flag;
        out->mapq[n] = mapq;
        out->tlen[n] = tlen;
        out->mate_tid[n] = mtid;
        out->mate_pos[n] = mpos;
        out->qname_hash[n] = fnv1a(qname, qname_len);
        out->left_soft[n] = lsoft;
        out->right_soft[n] = rsoft;
        out->ref_aln_len[n] = ref_aln;
        out->query_len[n] = qlen ? qlen : l_seq;
        out->lead_clip_q[n] = rev ? rclip : lclip;
        out->lib_id[n] = lib;
        out->has_sa[n] = sa.present ? 1 : 0;
        out->sa_tid[n] = sa.present ? sa.tid : -1;
        out->sa_pos[n] = sa.present ? sa.pos : -1;
        out->sa_end[n] = sa.present ? sa.end : -1;
        out->sa_is_reverse[n] = sa.present ? sa.rev : 0;
        out->sa_mapq[n] = sa.present ? sa.mapq : 0;
        out->sa_lead_clip_q[n] = sa.present ? sa.lead : 0;
        out->voffset[n] = vo;
        out->cov_a[n] =
            do_cov && tid == ca_tid && cov_acc_a == 2 * (int64_t)min_aligned;
        out->cov_b[n] =
            do_cov && tid == cb_tid && cov_acc_b == 2 * (int64_t)min_aligned;
        out_query_id[n] = (int32_t)q;
        for (size_t i = 0; i < bstart.size(); i++) {
          out->blk_start[blk_n + (int64_t)i] = bstart[i];
          out->blk_end[blk_n + (int64_t)i] = bend[i];
        }
        blk_n += (int64_t)bstart.size();
        out->blk_off[n + 1] = blk_n;
        n++;
      }
    }
    *io_range = -1;  // next query starts at its own first range
  }
  *io_query = n_queries;
  *io_voffset = UINT64_MAX;
  *out_rows = n;
  *out_scanned = scanned;
  return n;
}

// Fine-grained linear index build (one sequential header-only pass).
//
// The BAI linear index has fixed 16kb granularity, so a ~1kb fetch
// window pays a multi-kb lead-in decode before its first overlapping
// record. This builds a (1<<g_shift)-bp-granularity table:
// slot[tid][i] = voffset of the FIRST record whose alignment overlaps
// interval [i<<g, (i+1)<<g) — the exact analogue of the BAI ioff table.
// fetch_many then clamps each BAI chunk's start voffset up to
// slot[rlo>>g], eliminating the lead-in. Persisted by the Python side
// as a sidecar (<bam>.fidx.npz), i.e. an index artifact like the .bai.
//
// slot_off[tid] = first flat slot of tid; slot_off[n_ref] = total slots.
// Caller initializes out_vo to UINT64_MAX. Returns records scanned, -1
// on error.
long svt_build_fineidx(void* vh, uint64_t start_voffset, int32_t g_shift,
                       int32_t n_ref, const int64_t* slot_off,
                       uint64_t* out_vo) {
  SvtBam* h = static_cast<SvtBam*>(vh);
  VStream vs{h, (size_t)(start_voffset >> 16),
             (size_t)(start_voffset & 0xFFFF)};
  std::vector<uint8_t> rec;
  long scanned = 0;
  while (true) {
    if (!vs.ensure()) break;
    uint64_t vo = vs.voffset();
    uint8_t szb[4];
    if (!vs.read(szb, 4)) break;
    int32_t block_size;
    memcpy(&block_size, szb, 4);
    if (block_size < 32) {
      { std::lock_guard<std::mutex> g(g_err_mu); h->error = "bad record size"; }
      return -1;
    }
    uint8_t hdr[32];
    if (!vs.read(hdr, 32)) {
      { std::lock_guard<std::mutex> g(g_err_mu); h->error = "truncated record"; }
      return -1;
    }
    size_t rest = (size_t)block_size - 32;
    int32_t tid, pos;
    memcpy(&tid, hdr, 4);
    memcpy(&pos, hdr + 4, 4);
    uint8_t l_rn = hdr[8];
    uint16_t n_cig;
    memcpy(&n_cig, hdr + 12, 2);
    scanned++;
    if (tid < 0 || tid >= n_ref || pos < 0) {  // unmapped tail
      if (!vs.skip(rest)) break;
      continue;
    }
    size_t head_len = (size_t)l_rn + 4ull * n_cig;
    if (head_len > rest) {
      { std::lock_guard<std::mutex> g(g_err_mu); h->error = "bad record layout"; }
      return -1;
    }
    rec.resize(head_len);
    if (!vs.read(rec.data(), head_len)) {
      { std::lock_guard<std::mutex> g(g_err_mu); h->error = "truncated record"; }
      return -1;
    }
    if (!vs.skip(rest - head_len)) break;
    int64_t span = 0;
    {
      size_t coff = l_rn;
      for (uint16_t i = 0; i < n_cig; i++) {
        uint32_t v;
        memcpy(&v, rec.data() + coff, 4);
        coff += 4;
        if (OP_CR & (1u << (v & 0xF))) span += (int64_t)(v >> 4);
      }
    }
    if (span < 1) span = 1;  // placed-unmapped: still a valid lower bound
    int64_t b = (int64_t)pos >> g_shift;
    int64_t e = ((int64_t)pos + span - 1) >> g_shift;
    uint64_t* slot = out_vo + slot_off[tid];
    int64_t nslots = slot_off[tid + 1] - slot_off[tid];
    if (b >= nslots) continue;
    if (e >= nslots) e = nslots - 1;
    for (int64_t i = b; i <= e; i++)
      if (slot[i] == UINT64_MAX) slot[i] = vo;
  }
  return scanned;
}

// ------------------------------------------------- chunk fetch (layout)

// open-addressing hash (generation-cleared, grow-on-load): used per
// variant for qname-hash → pair-group index and for the multi-window
// voffset dedup set
struct GenMap {
  std::vector<uint64_t> key;
  std::vector<int32_t> val;
  std::vector<uint32_t> gen;
  uint32_t cur = 0;
  size_t mask = 0;
  size_t live = 0;

  void begin() {
    if (key.empty()) {
      key.assign(1024, 0);
      val.assign(1024, -1);
      gen.assign(1024, 0);
      mask = 1023;
    }
    cur++;
    live = 0;
  }
  void grow() {
    std::vector<uint64_t> ok;
    ok.swap(key);
    std::vector<int32_t> ov;
    ov.swap(val);
    std::vector<uint32_t> og;
    og.swap(gen);
    size_t cap = ok.size() * 2;
    key.assign(cap, 0);
    val.assign(cap, -1);
    gen.assign(cap, 0);
    mask = cap - 1;
    for (size_t i = 0; i < ok.size(); i++) {
      if (og[i] != cur) continue;
      size_t s = (size_t)(ok[i] * 0x9E3779B97F4A7C15ULL) & mask;
      while (gen[s] == cur) s = (s + 1) & mask;
      gen[s] = cur;
      key[s] = ok[i];
      val[s] = ov[i];
    }
  }
  // find-or-insert; *inserted reports which. Inserted slots start at -1.
  int32_t* find_or_insert(uint64_t k, bool* inserted) {
    if ((live + 1) * 2 > key.size()) grow();
    size_t s = (size_t)(k * 0x9E3779B97F4A7C15ULL) & mask;
    while (gen[s] == cur) {
      if (key[s] == k) {
        *inserted = false;
        return &val[s];
      }
      s = (s + 1) & mask;
    }
    gen[s] = cur;
    key[s] = k;
    val[s] = -1;
    live++;
    *inserted = true;
    return &val[s];
  }
};

struct PairMate {
  uint64_t vo;
  int32_t pos, end, tid, mtid, mpos;
  int16_t aln, lib;
  uint8_t rev, mapq;
};

struct PairGroup {
  uint64_t qh;
  int32_t cnt;
  PairMate m1, m2;
};

// extract._np_straddle over one concrete pair
static inline bool pair_straddle(const PairMate* a, const PairMate* b,
                                 int64_t t1, int64_t p1, int64_t c10,
                                 int64_t c11, int64_t t2, int64_t p2,
                                 int64_t c20, int64_t c21, bool o1, bool o2,
                                 int32_t min_aligned) {
  if ((a->rev != 0) != o1 || (b->rev != 0) != o2) return false;
  if (a->tid != t1 || b->tid != t2) return false;
  if (a->aln < min_aligned || b->aln < min_aligned) return false;
  const bool a_side =
      o1 ? (int64_t)a->end - 1 >= p1 + c10 : (int64_t)a->pos <= p1 + c11;
  const bool b_side =
      o2 ? (int64_t)b->end - 1 >= p2 + c20 : (int64_t)b->pos <= p2 + c21;
  return a_side && b_side;
}

struct ChunkTask {
  SvtBam* h;
  const int64_t *region_tid, *region_start, *region_end, *range_off;
  const uint64_t *range_beg, *range_end;
  const int32_t* var_of_query;
  int32_t drop_flags;
  const uint8_t* rg_keep;
  const int32_t* rg_to_lib;
  int32_t n_rg_tab;
  const int64_t *cov_tid_a, *cov_pos_a, *cov_tid_b, *cov_pos_b;
  int32_t min_aligned;
  int64_t max_reads;
  uint8_t* var_over;
  int64_t* var_rows;
  // compact-wire predicate tables (NULL → skip flag computation).
  // v_i32 rows follow extract.VARS_I32 (tid_a, pos_a, cia0, cia1,
  // tid_b, pos_b, cib0, cib1, vlen), v_u8 rows extract.VARS_BOOL
  // (o1, o2, is_del, is_dup, is_inv, force_null); stride = n_var.
  const int32_t* v_i32;
  const uint8_t* v_u8;
  int64_t v_stride;
  bool want_evidence;
};

// Decode the queries of [q_begin, q_end) — whole variants only — into
// cb: candidate-read rows at arrival, fragment pairs at variant close
// (groups ordered by qname hash; within a pair, mates ordered by
// (tid, pos, arrival) — byte-compatible with the numpy layout this
// replaces, evidence/extract.py).
static bool chunk_worker(const ChunkTask* T, int64_t q_begin, int64_t q_end,
                         ChunkBuf* cb, int64_t* scanned_out,
                         std::string* err) {
  SvtBam* h = T->h;
  VStream vs{h, 0, 0};
  std::vector<uint8_t> rec;  // block-spanning record fallback only
  GenMap gmap, voset;
  std::vector<PairGroup> groups;
  std::vector<std::pair<uint64_t, int32_t>> order;
  int64_t scanned = 0;
  const bool do_cov = T->cov_pos_a != nullptr;
  const int32_t min_aligned = T->min_aligned;

  const bool compact = T->v_i32 != nullptr;
  int64_t q = q_begin;
  while (q < q_end) {
    const int32_t v = T->var_of_query[q];
    int64_t q1 = q;
    while (q1 < q_end && T->var_of_query[q1] == v) q1++;
    VarPred vp{};
    if (compact) {
      const int64_t s = T->v_stride;
      vp.tid_a = T->v_i32[0 * s + v];
      vp.pos_a = T->v_i32[1 * s + v];
      vp.cia0 = T->v_i32[2 * s + v];
      vp.cia1 = T->v_i32[3 * s + v];
      vp.tid_b = T->v_i32[4 * s + v];
      vp.pos_b = T->v_i32[5 * s + v];
      vp.cib0 = T->v_i32[6 * s + v];
      vp.cib1 = T->v_i32[7 * s + v];
      vp.o1 = T->v_u8[0 * s + v] != 0;
      vp.o2 = T->v_u8[1 * s + v] != 0;
      vp.is_del = T->v_u8[2 * s + v] != 0;
      vp.is_inv = T->v_u8[4 * s + v] != 0;
    }
    const bool multi = (q1 - q) > 1;
    gmap.begin();
    groups.clear();
    if (multi) voset.begin();
    const size_t c_start = cb->c_var.size();
    int64_t rows_kept = 0;

    for (int64_t qq = q; qq < q1; qq++) {
      const int32_t rtid = (int32_t)T->region_tid[qq];
      const int64_t rlo = T->region_start[qq], rhi = T->region_end[qq];
      int64_t ca_tid = -1, ca_lo = 0, ca_hi = 0;
      int64_t cb_tid = -1, cb_lo = 0, cb_hi = 0;
      if (do_cov) {
        ca_tid = T->cov_tid_a[qq];
        ca_lo = T->cov_pos_a[qq] - min_aligned + 1;
        ca_hi = T->cov_pos_a[qq] + min_aligned + 1;
        cb_tid = T->cov_tid_b[qq];
        cb_lo = T->cov_pos_b[qq] - min_aligned + 1;
        cb_hi = T->cov_pos_b[qq] + min_aligned + 1;
      }
      for (int64_t r = T->range_off[qq]; r < T->range_off[qq + 1]; r++) {
        uint64_t vo0 = T->range_beg[r];
        vs.coffset = (size_t)(vo0 >> 16);
        vs.uoffset = (size_t)(vo0 & 0xFFFF);
        vs.eof = false;
        const uint64_t stop = T->range_end[r];
        while (true) {
          if (!vs.ensure()) break;
          uint64_t vo = vs.voffset();
          if (vo >= stop) break;
          // whole-record view: nearly every record sits inside one
          // inflated block, so parse in place — zero per-record
          // VStream calls and zero copies. The block outlives the
          // iteration (ubp shared_ptr). Records spanning blocks fall
          // back to one copy into ``rec``.
          int32_t block_size = 0;
          const uint8_t* rp = nullptr;
          {
            const BlockVec& blk = vs.ub();
            const size_t avail = blk.size() - vs.uoffset;
            if (avail >= 4) {
              memcpy(&block_size, blk.data() + vs.uoffset, 4);
              if (block_size >= 32 && 4 + (size_t)block_size <= avail) {
                rp = blk.data() + vs.uoffset + 4;
                vs.uoffset += 4 + (size_t)block_size;
              }
            }
          }
          if (rp == nullptr) {
            uint8_t szb[4];
            if (!vs.read(szb, 4)) break;
            memcpy(&block_size, szb, 4);
            if (block_size < 32) {
              *err = "bad record size";
              return false;
            }
            rec.resize((size_t)block_size);
            if (!vs.read(rec.data(), (size_t)block_size)) {
              *err = "truncated record";
              return false;
            }
            rp = rec.data();
          }
          int32_t tid, pos, l_seq, mtid, mpos;
          memcpy(&tid, rp, 4);
          memcpy(&pos, rp + 4, 4);
          uint8_t l_rn = rp[8], mapq = rp[9];
          uint16_t n_cig, flag;
          memcpy(&n_cig, rp + 12, 2);
          memcpy(&flag, rp + 14, 2);
          memcpy(&l_seq, rp + 16, 4);
          memcpy(&mtid, rp + 20, 4);
          memcpy(&mpos, rp + 24, 4);
          scanned++;
          if (tid != rtid || pos >= rhi) break;  // coordinate-sorted
          if ((flag & 0x4) || (flag & T->drop_flags)) continue;
          const size_t head_len = (size_t)l_rn + 4ull * n_cig;
          const size_t sq_len = ((size_t)l_seq + 1) / 2 + (size_t)l_seq;
          if (32 + head_len + sq_len > (size_t)block_size) {
            *err = "bad record layout";
            return false;
          }
          const uint8_t* qname = rp + 32;
          size_t qname_len = l_rn ? (size_t)l_rn - 1 : 0;
          const uint8_t* cig = rp + 32 + l_rn;

          // CG-aware: >65535-op records walk the CG:B,I array
          const uint8_t* eff_ops = cig;
          uint32_t eff_n = n_cig;
          if (n_cig == 2) {
            uint32_t cgn = 0;
            const uint8_t* cg = cg_long_cigar(
                cig, n_cig, l_seq, rp + 32 + head_len + sq_len,
                (size_t)block_size - 32 - head_len - sq_len, &cgn);
            if (cg) { eff_ops = cg; eff_n = cgn; }
          }

          // single cigar walk: ref span, clips, and breakpoint
          // coverage in one pass (left-of-window records drop on the
          // ref_end test below — no separate pre-skip walk)
          int32_t cur = pos, ref_aln = 0;
          int32_t lsoft = 0, rsoft = 0, lclip = 0, rclip = 0;
          int64_t cov_acc_a = 0, cov_acc_b = 0;
          {
            bool leading = true;
            int32_t trail_clip = 0, trail_soft = 0;
            for (uint32_t i = 0; i < eff_n; i++) {
              uint32_t cv;
              memcpy(&cv, eff_ops + 4ull * i, 4);
              uint32_t op = cv & 0xF, len = cv >> 4;
              bool is_clip = (op == 4 || op == 5);
              if (is_clip) {
                if (leading) {
                  lclip += (int32_t)len;
                  if (op == 4) lsoft += (int32_t)len;
                }
                // trailing stack accumulates over EVERY clip op and resets
                // at any non-clip (incl. P): an all-clip CIGAR is seen by
                // BOTH sides, matching CigarFeatures' independent end
                // scans (fuzz-found divergence, r4)
                trail_clip += (int32_t)len;
                if (op == 4) trail_soft += (int32_t)len;
              } else {
                leading = false;
                trail_clip = 0;
                trail_soft = 0;
              }
              if (OP_AL & (1u << op)) {
                ref_aln += (int32_t)len;
                if (do_cov) {
                  int64_t s = cur, e = cur + (int64_t)len;
                  int64_t oa =
                      (e < ca_hi ? e : ca_hi) - (s > ca_lo ? s : ca_lo);
                  if (oa > 0) cov_acc_a += oa;
                  int64_t ob =
                      (e < cb_hi ? e : cb_hi) - (s > cb_lo ? s : cb_lo);
                  if (ob > 0) cov_acc_b += ob;
                }
                cur += (int32_t)len;
              } else if (OP_CR & (1u << op)) {
                cur += (int32_t)len;
              }
            }
            rclip = trail_clip;
            rsoft = trail_soft;
          }
          const int32_t ref_end = cur;
          if (ref_end <= rlo) continue;
          const uint8_t* aux = rp + 32 + head_len + sq_len;
          const size_t aux_len = (size_t)block_size - 32 - head_len - sq_len;

          int32_t lib = -1;
          SaInfo sa;
          {
            size_t p = 0, end_ = aux_len;
            bool got_rg = false, got_sa = false;
            while (p + 3 <= end_ && !(got_rg && got_sa)) {
              uint8_t t0 = aux[p], t1 = aux[p + 1], typ = aux[p + 2];
              p += 3;
              switch (typ) {
                case 'A': case 'c': case 'C': p += 1; break;
                case 's': case 'S': p += 2; break;
                case 'i': case 'I': case 'f': p += 4; break;
                case 'Z': case 'H': {
                  size_t z = p;
                  while (z < end_ && aux[z]) z++;
                  if (t0 == 'R' && t1 == 'G' && typ == 'Z') {
                    got_rg = true;
                    const size_t vlen = z - p;
                    for (int32_t g = 0; g < h->n_rg_cached; g++) {
                      const std::string& rg = h->rg_cache[g];
                      if (rg.size() == vlen &&
                          memcmp(rg.data(), aux + p, vlen) == 0) {
                        lib = g;
                        break;
                      }
                    }
                  } else if (t0 == 'S' && t1 == 'A' && typ == 'Z') {
                    got_sa = true;
                    const uint8_t* s = aux + p;
                    const uint8_t* send = aux + z;
                    const uint8_t* semi = s;
                    while (semi < send && *semi != ';') semi++;
                    parse_sa_cached(h, s, semi, &sa);
                  }
                  p = z + 1;
                  break;
                }
                case 'B': {
                  if (p + 5 > end_) {
                    p = end_;
                    break;
                  }
                  uint8_t sub = aux[p];
                  uint32_t cnt;
                  memcpy(&cnt, aux + p + 1, 4);
                  size_t esz = (sub == 'c' || sub == 'C' || sub == 'A') ? 1
                               : (sub == 's' || sub == 'S')             ? 2
                                                                        : 4;
                  p += 5 + (size_t)cnt * esz;
                  break;
                }
                default:
                  p = end_;
              }
            }
          }
          if (T->rg_keep || T->rg_to_lib) {
            int32_t slot = (lib >= 0 && lib < T->n_rg_tab) ? lib : T->n_rg_tab;
            if (T->rg_keep && !T->rg_keep[slot]) continue;
            if (T->rg_to_lib) lib = T->rg_to_lib[slot];
          }
          if (multi) {
            bool ins;
            voset.find_or_insert(vo, &ins);
            if (!ins) continue;  // read spans both windows: keep first
          }
          rows_kept++;
          if (T->want_evidence) {
            cb->e_tid.push_back(tid);
            cb->e_pos.push_back(pos);
            cb->e_end.push_back(ref_end);
            cb->e_flag.push_back((int32_t)flag);
            cb->e_vo.push_back(vo);
          }
          const bool rev = (flag & 0x10) != 0;
          const uint8_t cova =
              do_cov && tid == ca_tid && cov_acc_a == 2 * (int64_t)min_aligned;
          const uint8_t covb =
              do_cov && tid == cb_tid && cov_acc_b == 2 * (int64_t)min_aligned;
          if (cova || covb || sa.present || lsoft > 0 || rsoft > 0) {
            cb->c_var.push_back(v);
            cb->c_tid.push_back(tid);
            cb->c_pos.push_back(pos);
            cb->c_end.push_back(ref_end);
            cb->c_lead.push_back(rev ? rclip : lclip);
            cb->c_sa_tid.push_back(sa.present ? sa.tid : -1);
            cb->c_sa_pos.push_back(sa.present ? sa.pos : -1);
            cb->c_sa_end.push_back(sa.present ? sa.end : -1);
            cb->c_sa_lead.push_back(sa.present ? sa.lead : 0);
            cb->c_rev.push_back(rev);
            cb->c_mapq.push_back(mapq);
            cb->c_lsoft.push_back(lsoft > 0);
            cb->c_rsoft.push_back(rsoft > 0);
            cb->c_cova.push_back(cova);
            cb->c_covb.push_back(covb);
            cb->c_hassa.push_back(sa.present ? 1 : 0);
            cb->c_sarev.push_back(sa.present ? sa.rev : 0);
            cb->c_samapq.push_back(sa.present ? sa.mapq : 0);
            if (compact) {
              // extract.compact_chunk read predicates, scalar form
              const bool covhit = cova || covb;
              const uint8_t sa_rev = sa.present ? sa.rev : 0;
              const bool same_strand_req = vp.o1 != vp.o2;
              const bool pieces_same = (rev ? 1 : 0) == sa_rev;
              const bool sa_ok = sa.present && (pieces_same == same_strand_req);
              const int32_t lead = rev ? rclip : lclip;
              const int32_t sa_lead = sa.present ? sa.lead : 0;
              const bool prim_first = lead <= sa_lead;
              const int64_t sa_tid = sa.present ? sa.tid : -1;
              const int64_t sa_pos = sa.present ? sa.pos : -1;
              const int64_t sa_end = sa.present ? sa.end : -1;
              const int64_t Lp = prim_first ? pos : sa_pos;
              const int64_t Le = prim_first ? ref_end : sa_end;
              const int64_t Lt = prim_first ? tid : sa_tid;
              const int64_t Rp = prim_first ? sa_pos : pos;
              const int64_t Re = prim_first ? sa_end : ref_end;
              const int64_t Rt = prim_first ? sa_tid : tid;
              const bool a1L = edge_in_window(Lp, Le, Lt, vp.tid_a,
                                              vp.pos_a, vp.cia0, vp.cia1,
                                              vp.o1);
              const bool a1R = edge_in_window(Rp, Re, Rt, vp.tid_b,
                                              vp.pos_b, vp.cib0, vp.cib1,
                                              vp.o2);
              const bool a2L = edge_in_window(Lp, Le, Lt, vp.tid_b,
                                              vp.pos_b, vp.cib0, vp.cib1,
                                              vp.o2);
              const bool a2R = edge_in_window(Rp, Re, Rt, vp.tid_a,
                                              vp.pos_a, vp.cia0, vp.cia1,
                                              vp.o1);
              const bool use1 = (int)a1L + (int)a1R >= (int)a2L + (int)a2R;
              const bool lhit = sa_ok && (use1 ? a1L : a2L);
              const bool rhit = sa_ok && (use1 ? a1R : a2R);
              const bool hit_a = edge_in_window(pos, ref_end, tid, vp.tid_a,
                                                vp.pos_a, vp.cia0, vp.cia1,
                                                vp.o1);
              const bool hit_b = edge_in_window(pos, ref_end, tid, vp.tid_b,
                                                vp.pos_b, vp.cib0, vp.cib1,
                                                vp.o2);
              const bool clip_a =
                  (!vp.o1 && rsoft > 0 && hit_a) || (vp.o1 && lsoft > 0 && hit_a);
              const bool clip_b =
                  (!vp.o2 && rsoft > 0 && hit_b) || (vp.o2 && lsoft > 0 && hit_b);
              const bool clip_hit = !sa.present && (lsoft > 0 || rsoft > 0) &&
                                    (clip_a || clip_b);
              cb->c_rflags.push_back(
                  (uint8_t)(covhit * R_COVHIT + clip_hit * R_CLIPHIT +
                            lhit * R_LHIT + rhit * R_RHIT +
                            prim_first * R_PRIMFIRST));
            }
          }
          if ((flag & 0x1) && !(flag & 0x8)) {  // paired, mate mapped
            bool ins;
            int32_t* slot = gmap.find_or_insert(fnv1a(qname, qname_len), &ins);
            if (ins) {
              *slot = (int32_t)groups.size();
              groups.push_back(
                  PairGroup{fnv1a(qname, qname_len), 0, {}, {}});
            }
            PairGroup& g = groups[*slot];
            g.cnt++;
            if (g.cnt <= 2) {
              PairMate m;
              m.vo = vo;
              m.pos = pos;
              m.end = ref_end;
              m.tid = tid;
              m.mtid = mtid;
              m.mpos = mpos;
              m.aln = (int16_t)(ref_aln < 0x7FFF ? ref_aln : 0x7FFF);
              m.lib = (int16_t)(lib < 0x7FFF ? lib : 0x7FFF);
              m.rev = rev;
              m.mapq = mapq;
              if (g.cnt == 1)
                g.m1 = m;
              else
                g.m2 = m;
            }
          }
        }
      }
    }
    T->var_rows[v] += rows_kept;  // threads own whole variants
    if (T->max_reads >= 0 && T->var_rows[v] > T->max_reads) {
      cb->truncate_cands(c_start);
      T->var_over[v] = 1;
    } else {
      order.clear();
      for (int32_t gi = 0; gi < (int32_t)groups.size(); gi++)
        if (groups[gi].cnt == 2) order.emplace_back(groups[gi].qh, gi);
      std::sort(order.begin(), order.end());
      for (auto& kv : order) {
        PairGroup& g = groups[kv.second];
        PairMate *a = &g.m1, *b = &g.m2;
        if (b->tid < a->tid || (b->tid == a->tid && b->pos < a->pos)) {
          PairMate* t = a;
          a = b;
          b = t;
        }
        // mate-identity check: a 64-bit qname-hash collision could pair
        // two unrelated fragments; requiring each mate's MRNM/MPOS to
        // point at the other recovers the reference's exact-qname
        // grouping semantics (a mismatched "pair" is dropped, exactly
        // as a >2 group is)
        if (a->mtid != b->tid || a->mpos != b->pos || b->mtid != a->tid ||
            b->mpos != a->pos)
          continue;
        cb->p_var.push_back(v);
        cb->p_apos.push_back(a->pos);
        cb->p_aend.push_back(a->end);
        cb->p_bpos.push_back(b->pos);
        cb->p_bend.push_back(b->end);
        cb->p_atid.push_back(a->tid);
        cb->p_btid.push_back(b->tid);
        cb->p_aaln.push_back(a->aln);
        cb->p_baln.push_back(b->aln);
        cb->p_alib.push_back(a->lib);
        cb->p_arev.push_back(a->rev);
        cb->p_brev.push_back(b->rev);
        cb->p_amapq.push_back(a->mapq);
        cb->p_bmapq.push_back(b->mapq);
        if (compact) {
          // extract.compact_chunk pair predicates, scalar form
          const int32_t ma = T->min_aligned;
          const bool ref_a = pair_straddle(
              a, b, vp.tid_a, vp.pos_a, vp.cia0, vp.cia1, vp.tid_a,
              vp.pos_a, vp.cia0, vp.cia1, false, true, ma);
          const bool ref_b = pair_straddle(
              a, b, vp.tid_b, vp.pos_b, vp.cib0, vp.cib1, vp.tid_b,
              vp.pos_b, vp.cib0, vp.cib1, false, true, ma);
          const bool ref_gate =
              (ref_a || ref_b) && (!(ref_a && ref_b) || vp.is_del);
          const uint8_t refw = ref_gate ? (uint8_t)ref_a + (uint8_t)ref_b : 0;
          const bool alt = pair_straddle(
              a, b, vp.tid_a, vp.pos_a, vp.cia0, vp.cia1, vp.tid_b,
              vp.pos_b, vp.cib0, vp.cib1, vp.o1, vp.o2, ma);
          const bool alt_rec =
              vp.is_inv && pair_straddle(a, b, vp.tid_a, vp.pos_a, vp.cia0,
                                         vp.cia1, vp.tid_b, vp.pos_b,
                                         vp.cib0, vp.cib1, !vp.o1, !vp.o2,
                                         ma);
          cb->p_flags.push_back(
              (uint8_t)(alt * P_ALT + alt_rec * P_ALTREC + refw * 4));
          // i32 wrap matches numpy's np.subtract(dtype=int32)
          cb->p_ospan.push_back((int32_t)((uint32_t)b->end - (uint32_t)a->pos));
          if (a->lib >= LIB_INVALID) {
            *err = "compact wire supports < 255 libraries";
            return false;
          }
          cb->p_libu8.push_back(
              a->lib < 0 ? LIB_INVALID : (uint8_t)a->lib);
        }
      }
    }
    q = q1;
  }
  *scanned_out = scanned;
  return true;
}

// Chunked fetch + full device layout in one call: decode every window,
// filter, dedup multi-window variants, select candidate reads, form
// fragment pairs, and apply max_reads — the C++ replacement for the
// numpy layout in evidence/extract.py::prepare_chunk. Results stay in
// the handle's arena; call svt_chunk_export to copy them into the
// padded device matrices. Returns 0, or -1 on error.
long svt_fetch_chunk(void* vh,
                     int64_t n_queries,
                     const int64_t* region_tid,
                     const int64_t* region_start,
                     const int64_t* region_end,
                     const int64_t* range_off,
                     const uint64_t* range_beg,
                     const uint64_t* range_end_,
                     const int32_t* var_of_query,
                     int32_t drop_flags,
                     const uint8_t* rg_keep,
                     const int32_t* rg_to_lib,
                     int32_t n_rg_tab,
                     const int64_t* cov_tid_a, const int64_t* cov_pos_a,
                     const int64_t* cov_tid_b, const int64_t* cov_pos_b,
                     int32_t min_aligned,
                     int64_t max_reads,
                     int32_t n_threads,
                     const int32_t* v_i32, const uint8_t* v_u8,
                     int64_t v_stride,
                     int64_t* out_n_cand, int64_t* out_n_pair,
                     uint8_t* var_over, int64_t* var_rows,
                     int64_t* out_scanned) {
  SvtBam* h = static_cast<SvtBam*>(vh);
  if (n_threads < 1) n_threads = 1;
  // partition queries at variant boundaries, balanced by range count
  std::vector<int64_t> bounds{0};
  const int64_t total = n_queries ? range_off[n_queries] : 0;
  for (int32_t t = 1; t < n_threads; t++) {
    int64_t target = total * t / n_threads;
    int64_t qi =
        std::lower_bound(range_off, range_off + n_queries, target) - range_off;
    while (qi > 0 && qi < n_queries &&
           var_of_query[qi] == var_of_query[qi - 1])
      qi++;
    if (qi < bounds.back()) qi = bounds.back();
    bounds.push_back(qi);
  }
  bounds.push_back(n_queries);
  const int T = (int)bounds.size() - 1;
  if ((int)h->chunk_bufs.size() < T) h->chunk_bufs.resize(T);
  for (int t = 0; t < T; t++) h->chunk_bufs[t].clear();

  ChunkTask task{h, region_tid, region_start, region_end, range_off,
                 range_beg, range_end_, var_of_query, drop_flags, rg_keep,
                 rg_to_lib, n_rg_tab, cov_tid_a, cov_pos_a, cov_tid_b,
                 cov_pos_b, min_aligned, max_reads, var_over, var_rows,
                 v_i32, v_u8, v_stride, h->want_evidence != 0};
  std::vector<int64_t> scans(T, 0);
  std::vector<std::string> errs(T);
  std::vector<char> oks(T, 1);
  auto run_worker = [&](int t) {
    const int64_t t0 = now_ns();
    oks[t] = chunk_worker(&task, bounds[t], bounds[t + 1],
                          &h->chunk_bufs[t], &scans[t], &errs[t]);
    g_perf_worker_ns.fetch_add(now_ns() - t0, std::memory_order_relaxed);
  };
  if (T == 1) {
    run_worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) {
      threads.emplace_back([&, t] { run_worker(t); });
    }
    for (auto& th : threads) th.join();
  }
  int64_t n_cand = 0, n_pair = 0, scanned = 0;
  for (int t = 0; t < T; t++) {
    if (!oks[t]) {
      { std::lock_guard<std::mutex> g(g_err_mu); h->error = errs[t]; }
      return -1;
    }
    n_cand += (int64_t)h->chunk_bufs[t].c_var.size();
    n_pair += (int64_t)h->chunk_bufs[t].p_var.size();
    scanned += scans[t];
  }
  *out_n_cand = n_cand;
  *out_n_pair = n_pair;
  *out_scanned = scanned;
  return 0;
}

// Copy the arena from the last svt_fetch_chunk into padded matrices.
// Column order matches evidence/extract.py: READS_I32 = (var, tid, pos,
// end, lead, sa_tid, sa_pos, sa_end, sa_lead), READS_U8 = (is_rev, mapq,
// has_lsoft, has_rsoft, cov_a, cov_b, has_sa, sa_rev, sa_mapq),
// PAIRS_I32 = (var, a_pos, a_end, b_pos, b_end, a_tid, b_tid),
// PAIRS_I16 = (a_aln, b_aln, a_lib), PAIRS_U8 = (a_rev, b_rev, a_mapq,
// b_mapq). Strides are the padded row lengths.
long svt_chunk_export(void* vh, int32_t* r_i32, uint8_t* r_u8,
                      int64_t r_stride, int32_t* p_i32, int16_t* p_i16,
                      uint8_t* p_u8, int64_t p_stride) {
  SvtBam* h = static_cast<SvtBam*>(vh);
  int64_t co = 0, po = 0;
  for (auto& cb : h->chunk_bufs) {
    const size_t n = cb.c_var.size();
    if (n) {
      const int32_t* ci32[9] = {cb.c_var.data(),    cb.c_tid.data(),
                                cb.c_pos.data(),    cb.c_end.data(),
                                cb.c_lead.data(),   cb.c_sa_tid.data(),
                                cb.c_sa_pos.data(), cb.c_sa_end.data(),
                                cb.c_sa_lead.data()};
      const uint8_t* cu8[9] = {cb.c_rev.data(),   cb.c_mapq.data(),
                               cb.c_lsoft.data(), cb.c_rsoft.data(),
                               cb.c_cova.data(),  cb.c_covb.data(),
                               cb.c_hassa.data(), cb.c_sarev.data(),
                               cb.c_samapq.data()};
      for (int k = 0; k < 9; k++) {
        memcpy(r_i32 + (int64_t)k * r_stride + co, ci32[k], n * 4);
        memcpy(r_u8 + (int64_t)k * r_stride + co, cu8[k], n);
      }
      co += (int64_t)n;
    }
    const size_t m = cb.p_var.size();
    if (m) {
      const int32_t* pi32[7] = {cb.p_var.data(),  cb.p_apos.data(),
                                cb.p_aend.data(), cb.p_bpos.data(),
                                cb.p_bend.data(), cb.p_atid.data(),
                                cb.p_btid.data()};
      const int16_t* pi16[3] = {cb.p_aaln.data(), cb.p_baln.data(),
                                cb.p_alib.data()};
      const uint8_t* pu8[4] = {cb.p_arev.data(), cb.p_brev.data(),
                               cb.p_amapq.data(), cb.p_bmapq.data()};
      for (int k = 0; k < 7; k++)
        memcpy(p_i32 + (int64_t)k * p_stride + po, pi32[k], m * 4);
      for (int k = 0; k < 3; k++)
        memcpy(p_i16 + (int64_t)k * p_stride + po, pi16[k], m * 2);
      for (int k = 0; k < 4; k++)
        memcpy(p_u8 + (int64_t)k * p_stride + po, pu8[k], m);
      po += (int64_t)m;
    }
  }
  return 0;
}

// Copy the compact-wire tables of the last svt_fetch_chunk (run with
// v_i32/v_u8 predicate tables) into padded matrices. Row layout matches
// extract.COMPACT_KEYS: cr_u16 = [var], cr_u8 = [mapq, sa_mapq, rflags],
// cp_u16 = [var], cp_i32 = [ospan], cp_u8 = [a_mapq, b_mapq, lib, pflags].
// Caller owns padding rows (see extract.prepare_compact_chunk).
long svt_chunk_export_compact(void* vh, uint16_t* cr_u16, uint8_t* cr_u8,
                              int64_t r_stride, uint16_t* cp_u16,
                              int32_t* cp_i32, uint8_t* cp_u8,
                              int64_t p_stride) {
  SvtBam* h = static_cast<SvtBam*>(vh);
  int64_t co = 0, po = 0;
  for (auto& cb : h->chunk_bufs) {
    const size_t n = cb.c_var.size();
    if (cb.c_rflags.size() != n || cb.p_flags.size() != cb.p_var.size()) {
      std::lock_guard<std::mutex> g(g_err_mu);
      h->error = "fetch_chunk was not run in compact mode";
      return -1;
    }
    for (size_t i = 0; i < n; i++)
      cr_u16[co + (int64_t)i] = (uint16_t)cb.c_var[i];
    if (n) {
      memcpy(cr_u8 + 0 * r_stride + co, cb.c_mapq.data(), n);
      memcpy(cr_u8 + 1 * r_stride + co, cb.c_samapq.data(), n);
      memcpy(cr_u8 + 2 * r_stride + co, cb.c_rflags.data(), n);
    }
    co += (int64_t)n;
    const size_t m = cb.p_var.size();
    for (size_t i = 0; i < m; i++)
      cp_u16[po + (int64_t)i] = (uint16_t)cb.p_var[i];
    if (m) {
      memcpy(cp_i32 + po, cb.p_ospan.data(), m * 4);
      memcpy(cp_u8 + 0 * p_stride + po, cb.p_amapq.data(), m);
      memcpy(cp_u8 + 1 * p_stride + po, cb.p_bmapq.data(), m);
      memcpy(cp_u8 + 2 * p_stride + po, cb.p_libu8.data(), m);
      memcpy(cp_u8 + 3 * p_stride + po, cb.p_flags.data(), m);
    }
    po += (int64_t)m;
  }
  return 0;
}

// toggle -w evidence-row recording for subsequent svt_fetch_chunk calls
void svt_set_evidence(void* vh, int32_t on) {
  static_cast<SvtBam*>(vh)->want_evidence = on;
}

// rows recorded by the last evidence-mode svt_fetch_chunk
long svt_chunk_evidence_count(void* vh) {
  SvtBam* h = static_cast<SvtBam*>(vh);
  int64_t n = 0;
  for (auto& cb : h->chunk_bufs) n += (int64_t)cb.e_vo.size();
  return (long)n;
}

// copy them out (arrays sized >= svt_chunk_evidence_count)
long svt_chunk_export_evidence(void* vh, int32_t* tid, int32_t* pos,
                               int32_t* end, int32_t* flag, uint64_t* vo) {
  SvtBam* h = static_cast<SvtBam*>(vh);
  int64_t o = 0;
  for (auto& cb : h->chunk_bufs) {
    const size_t n = cb.e_vo.size();
    if (!n) continue;
    memcpy(tid + o, cb.e_tid.data(), n * 4);
    memcpy(pos + o, cb.e_pos.data(), n * 4);
    memcpy(end + o, cb.e_end.data(), n * 4);
    memcpy(flag + o, cb.e_flag.data(), n * 4);
    memcpy(vo + o, cb.e_vo.data(), n * 8);
    o += (int64_t)n;
  }
  return (long)o;
}

// cache ref/rg name tables on the handle so fetch_many needn't take them
void svt_set_names(void* vh, const char* const* ref_names, int32_t n_ref,
                   const char* const* rg_names, int32_t n_rg) {
  SvtBam* h = static_cast<SvtBam*>(vh);
  h->ref_cache.clear();
  for (int32_t i = 0; i < n_ref; i++) h->ref_cache.push_back(ref_names[i]);
  h->ref_ptrs.clear();
  for (auto& r : h->ref_cache) h->ref_ptrs.push_back(r.c_str());
  h->rg_cache.clear();
  for (int32_t i = 0; i < n_rg; i++) h->rg_cache.push_back(rg_names[i]);
  h->n_rg_cached = n_rg;
}

// Drain the process-wide perf counters into out[6] =
// {inflate_ns, blocks_inflated, worker_ns, cache_hits, inflate_bytes,
//  inflate_cpu_ns} and reset them.
void svt_perf(int64_t* out) {
  out[0] = g_perf_inflate_ns.exchange(0, std::memory_order_relaxed);
  out[1] = g_perf_blocks.exchange(0, std::memory_order_relaxed);
  out[2] = g_perf_worker_ns.exchange(0, std::memory_order_relaxed);
  out[3] = g_perf_cache_hits.exchange(0, std::memory_order_relaxed);
  out[4] = g_perf_inflate_bytes.exchange(0, std::memory_order_relaxed);
  out[5] = g_perf_inflate_cpu_ns.exchange(0, std::memory_order_relaxed);
}

// ABI contract between this library and bamio/native.py: bump whenever
// ANY existing entry point's signature or semantics change. native.py
// refuses to bind a stale .so whose version mismatches its expectation
// (a stale library that merely MISSES new symbols degrades per-symbol;
// one with a CHANGED signature would otherwise bind cleanly and be
// called with the new argtypes — silent memory corruption; advisor
// finding, r4).
int32_t svt_abi_version(void) { return 8; }

// Single-thread BGZF inflate roofline: re-inflate the first
// max_blocks BGZF blocks of the handle's file in a tight loop,
// bypassing the block cache. Returns inflated bytes (compressed bytes
// consumed in *compressed_out, wall-ns in *ns_out), or -1. Used by
// bench.py to report achieved-vs-roofline inflate bandwidth on the
// measurement host (VERDICT r4 item 2).
//
// retain=0: one hot reused output buffer — the absolute peak, but
// unattainable by a cache that KEEPS blocks (no first-touch page
// cost). retain=1: every block gets a fresh allocation that stays
// live, the block cache's true allocation pattern — the fair roofline
// for the cold pass (measured 3.1 vs 0.78 GB/s on the bench host:
// the kernel page-fault/zeroing tax of growing a resident set
// dominates, and THP/madvise made it far worse, not better).
int64_t svt_inflate_roofline(void* handle, int64_t max_blocks,
                             int32_t retain,
                             int64_t* compressed_out, int64_t* ns_out) {
  SvtBam* h = (SvtBam*)handle;
  if (!h || !h->data()) return -1;
  const uint8_t* b = h->data();
  const size_t fsize = h->size();
  int64_t inflated = 0, compressed = 0, blocks = 0;
  std::vector<uint8_t> out;
  std::vector<std::shared_ptr<BlockVec>> kept;
#ifdef USE_LIBDEFLATE
  struct libdeflate_decompressor* ld = libdeflate_alloc_decompressor();
#endif
  const int64_t t0 = now_ns();
  size_t co = 0;
  while (co + 18 <= fsize && (max_blocks < 0 || blocks < max_blocks)) {
    if (b[co] != 0x1f || b[co + 1] != 0x8b) break;
    uint16_t xlen;
    memcpy(&xlen, b + co + 10, 2);
    size_t xoff = co + 12, xend = xoff + xlen;
    size_t bsize = 0;
    while (xoff + 4 <= xend && xend <= fsize) {
      uint8_t si1 = b[xoff], si2 = b[xoff + 1];
      uint16_t slen;
      memcpy(&slen, b + xoff + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, b + xoff + 4, 2);
        bsize = (size_t)bs + 1;
      }
      xoff += 4 + slen;
    }
    if (!bsize || co + bsize > fsize) break;
    uint32_t isize;
    memcpy(&isize, b + co + bsize - 4, 4);
    if (isize) {
      uint8_t* dst;
      if (retain) {
        kept.push_back(std::make_shared<BlockVec>(isize));
        dst = (uint8_t*)kept.back()->data();
      } else {
        if (out.size() < isize) out.resize(isize);
        dst = out.data();
      }
      bool ok = false;
#ifdef USE_LIBDEFLATE
      size_t actual = 0;
      ok = libdeflate_deflate_decompress(ld, b + xend, co + bsize - 8 - xend,
                                         dst, isize, &actual) ==
               LIBDEFLATE_SUCCESS &&
           actual == isize;
#else
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) == Z_OK) {
        zs.next_in = const_cast<uint8_t*>(b) + xend;
        zs.avail_in = (uInt)(co + bsize - 8 - xend);
        zs.next_out = dst;
        zs.avail_out = isize;
        ok = inflate(&zs, Z_FINISH) == Z_STREAM_END &&
             zs.total_out == (uLong)isize;
        inflateEnd(&zs);
      }
#endif
      if (!ok) break;
      inflated += (int64_t)isize;
      ++blocks;
    }
    compressed += (int64_t)bsize;
    co += bsize;
  }
  if (ns_out) *ns_out = now_ns() - t0;
#ifdef USE_LIBDEFLATE
  libdeflate_free_decompressor(ld);
#endif
  if (compressed_out) *compressed_out = compressed;
  return inflated;
}

}  // extern "C"
