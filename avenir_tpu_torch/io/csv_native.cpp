// Native CSV -> columnar ingest: the reader behind core/table.py's load_csv
// and iter_csv_chunks.  The port's own copy of the JAX package's reader, so
// both packages parse a file to the same columns byte for byte.
//
// An mmap + memchr two-phase parser filling preallocated numpy buffers
// through a minimal C ABI (ctypes on the Python side, io/native_csv.py):
//   phase A  line index: memchr-driven newline scan (SIMD inside glibc),
//            storing one (start:int64, len:int32) per non-blank line —
//            12 bytes a row;
//   phase B  fused fill: ONE walk over each row's fields dispatching every
//            requested column directly into its output buffer (numeric ->
//            from_chars float64, categorical -> small-vocab lookup int32,
//            string -> per-thread blob + lengths, joined once).  avt_fill
//            covers all rows; avt_fill_range fills one row block of the
//            same index (the streamed ingest's parse stage).
// Both phases shard by byte/row ranges across a thread pool
// (AVENIR_TPU_INGEST_THREADS caps it; with one hardware thread the pool is
// bypassed).
//
// Matches the columnar table contract of core/table.py: numeric -> float64,
// categorical -> int32 vocab codes (-1 unknown), id/string -> joined blob +
// int64 offsets (lazy decode on the Python side), bucketWidth-binned
// numeric -> int32 codes from numpy's floor divide (np_floor_divide).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread [-march=native], driven
// by io/native_csv.py.  Never -ffast-math: the floor divide's fmod
// correction and the float grammar must round as IEEE doubles do.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Handle {
    const char* data = nullptr;   // mmap'd file (nullptr for empty file)
    size_t size = 0;
    int fd = -1;
    char delim = ',';
    int n_threads = 1;
    bool explicit_threads = false;  // caller pinned the count (tests
                                    // exercise the pool this way)
    std::vector<int64_t> starts;  // per non-blank line: byte offset
    std::vector<int32_t> lens;    // per non-blank line: byte length
    // per string column (fill-call order): joined bytes + n+1 offsets
    std::vector<std::string> str_blobs;
    std::vector<std::vector<int64_t>> str_offsets;

    ~Handle() {  // any exit path (incl. avt_open's catch) releases the map
        if (data != nullptr)
            ::munmap(const_cast<char*>(data), size);
        if (fd >= 0)
            ::close(fd);
    }
};

// Inline delimiter scan for SHORT fields: a glibc memchr call costs ~50+
// cycles in PLT/setup, which dominates on ~6-byte CSV fields (7 calls per
// 42-byte row measured ~75% of the whole parse).  SWAR over unaligned
// 8-byte loads, guarded so no load crosses `hard_end` (the mmap boundary).
inline const char* find_byte(const char* p, const char* end, char c,
                             const char* hard_end) {
    const uint64_t pat = 0x0101010101010101ull
        * static_cast<unsigned char>(c);
    while (p + 8 <= end || (p + 8 <= hard_end && p < end)) {
        uint64_t w;
        std::memcpy(&w, p, 8);  // compiles to one unaligned load
        uint64_t x = w ^ pat;
        uint64_t hit = (x - 0x0101010101010101ull) & ~x
            & 0x8080808080808080ull;
        if (hit) {
            const char* q = p
                + (__builtin_ctzll(hit) >> 3);  // little-endian byte index
            return q < end ? q : nullptr;
        }
        p += 8;
    }
    for (; p < end; ++p)
        if (*p == c) return p;
    return nullptr;
}

inline bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n'
        || c == '\v' || c == '\f';
}

// First <=8 bytes of a field as a zero-padded little-endian word, without
// ever loading past `hard_end` (the mmap boundary).
inline uint64_t load8_masked(const char* p, size_t len,
                             const char* hard_end) {
    if (len == 0) return 0;  // a shift by 64 below would be UB
    uint64_t w = 0;
    if (p + 8 <= hard_end)
        std::memcpy(&w, p, 8);
    else
        std::memcpy(&w, p, len < 8 ? len : 8);
    if (len < 8)
        w &= ~0ull >> (8 * (8 - len));
    return w;
}

// numpy floor_divide semantics (npy_divmod): fmod-corrected, NOT a plain
// floor(a/b) — they differ whenever a/b rounds up to an exact f64 integer
// (e.g. 511.8 / 0.1 -> 5118.0 but 511.8 // 0.1 == 5117.0).  Bin codes must
// match the python oracle's `col // bucketWidth` bit for bit.
inline double np_floor_divide(double a, double b) {
    double mod = std::fmod(a, b);
    if (mod != 0.0 && ((b < 0.0) != (mod < 0.0)))
        mod += b;
    double div = (a - mod) / b;
    if (div != 0.0) {
        double fd = std::floor(div);
        if (div - fd > 0.5)
            fd += 1.0;
        return fd;
    }
    return std::copysign(0.0, a / b);
}

// Sign + pure-digit fast path (the overwhelmingly common CSV number shape);
// ~4x cheaper than from_chars<double>, which measured as the largest single
// cost of the fill pass.  Returns false (caller uses from_chars) for
// decimals, exponents, >18 digits, or anything else unusual.
inline bool parse_simple_number(std::string_view v, double* out) {
    const char* p = v.data();
    const char* e = p + v.size();
    bool neg = false;
    if (p < e && *p == '-') { neg = true; ++p; }
    if (p == e || e - p > 18) return false;
    uint64_t acc = 0;
    for (; p < e; ++p) {
        unsigned d = static_cast<unsigned char>(*p) - '0';
        if (d > 9) return false;
        acc = acc * 10 + d;
    }
    *out = neg ? -static_cast<double>(acc) : static_cast<double>(acc);
    return true;
}

// Full float parse for the non-simple shapes (decimals, exponents).
// GCC >= 11 has floating-point from_chars; older libstdc++ (GCC 10) only
// has the integer overloads, so fall back to
// glibc strtod — also correctly rounded — with its extensions neutralized:
// hex floats are rejected (python float() rejects them, and the native
// path must never parse where the oracle raises) and the mmap slice is
// copied to a NUL-terminated stack buffer (strtod needs termination).
inline bool parse_general_number(std::string_view v, double* out) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
    auto res = std::from_chars(v.data(), v.data() + v.size(), *out);
    return res.ec == std::errc() && res.ptr == v.data() + v.size();
#else
    if (v.empty() || v.size() > 64) return false;  // absurd width: oracle path
    // match the from_chars grammar exactly: no leading '+' (the caller
    // already stripped the single '+' python allows) and no leading
    // whitespace — strtod accepts both, which would make this build parse
    // fields (e.g. '++1', '+ 1') where the oracle raises
    if (v[0] == '+' || is_space(v[0])) return false;
    for (char c : v)
        if (c == 'x' || c == 'X') return false;
    char buf[65];
    std::memcpy(buf, v.data(), v.size());
    buf[v.size()] = '\0';
    errno = 0;
    char* end = nullptr;
    double d = std::strtod(buf, &end);
    // ERANGE == from_chars result_out_of_range: counted bad, same as the
    // primary implementation
    if (end != buf + v.size() || errno == ERANGE) return false;
    *out = d;
    return true;
#endif
}

inline std::string_view trimmed(const char* p, int64_t len) {
    while (len > 0 && is_space(p[0])) { ++p; --len; }
    while (len > 0 && is_space(p[len - 1])) --len;
    return std::string_view(p, static_cast<size_t>(len));
}

inline bool blank_line(const char* p, int64_t len) {
    // fast path: a real record starts with a non-space byte
    if (len == 0) return true;
    if (!is_space(p[0])) return false;
    for (int64_t i = 1; i < len; ++i)
        if (!is_space(p[i])) return false;
    return true;
}

// First line start at or after `from`: a position p is a line start iff
// p == 0, or buf[p-1] == '\n', or (buf[p-1] == '\r' and buf[p] != '\n' —
// the '\n' of a CRLF pair is not a start).  Used to align thread ranges.
size_t next_line_start(const char* buf, size_t size, size_t from) {
    if (from == 0) return 0;
    for (size_t p = from - 1; p < size; ++p) {
        if (buf[p] == '\n') return p + 1;
        if (buf[p] == '\r')
            return (p + 1 < size && buf[p + 1] == '\n') ? p + 2 : p + 1;
    }
    return size;
}

// Scan lines whose START lies in [lo, hi) (a line may extend past hi; the
// thread owning its start parses all of it).  '\n', '\r\n' and bare '\r'
// all terminate lines, matching python str.splitlines on CSV data.
void index_range(const char* buf, size_t size, size_t lo, size_t hi,
                 std::vector<int64_t>* starts, std::vector<int32_t>* lens) {
    starts->reserve((hi - lo) / 32 + 1);
    lens->reserve((hi - lo) / 32 + 1);
    // overwhelmingly common case: no '\r' anywhere in the range — one
    // range-wide memchr buys skipping the per-line '\r' scan entirely.
    // A line that STARTS before hi may extend past it, so lines crossing
    // the boundary still get the per-line check.
    if (std::memchr(buf + lo, '\r', hi - lo) == nullptr) {
        size_t p = lo;
        while (p < hi) {
            const char* here = buf + p;
            const char* nl = static_cast<const char*>(
                std::memchr(here, '\n', size - p));
            const char* term = nl ? nl : buf + size;
            if (static_cast<size_t>(term - buf) > hi) {
                // crosses the checked range: '\r' possible after hi
                const char* cr = static_cast<const char*>(std::memchr(
                    buf + hi, '\r', static_cast<size_t>(term - buf) - hi));
                if (cr) term = cr;
            }
            int64_t len = term - here;
            if (!blank_line(here, len)) {
                starts->push_back(static_cast<int64_t>(p));
                lens->push_back(static_cast<int32_t>(len));
            }
            size_t t = static_cast<size_t>(term - buf);
            if (t >= size) break;
            p = (buf[t] == '\r' && t + 1 < size && buf[t + 1] == '\n')
                    ? t + 2 : t + 1;
        }
        return;
    }
    size_t p = lo;
    // cache the memchr('\n') result across the bare-'\r' splits inside one
    // physical line; buf+size is the 'no \n remains' sentinel (a nullptr
    // sentinel would rescan to EOF for EVERY line of a \r-only file — O(n^2))
    const char* cached_nl = nullptr;
    while (p < hi) {
        const char* here = buf + p;
        if (cached_nl == nullptr || (cached_nl < here
                                     && cached_nl != buf + size)) {
            const char* found = static_cast<const char*>(
                std::memchr(here, '\n', size - p));
            cached_nl = found ? found : buf + size;
        }
        const char* nl = cached_nl;
        const char* cr = static_cast<const char*>(
            std::memchr(here, '\r', static_cast<size_t>(nl - here)));
        const char* term = cr ? cr : nl;
        int64_t len = term - here;
        if (!blank_line(here, len)) {
            starts->push_back(static_cast<int64_t>(p));
            lens->push_back(static_cast<int32_t>(len));
        }
        size_t t = static_cast<size_t>(term - buf);
        if (t >= size) break;
        p = (buf[t] == '\r' && t + 1 < size && buf[t + 1] == '\n') ? t + 2
                                                                   : t + 1;
    }
}

void run_sharded(int n_threads, const std::function<void(int)>& body) {
    if (n_threads <= 1) { body(0); return; }
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(n_threads) - 1);
    for (int t = 1; t < n_threads; ++t) pool.emplace_back(body, t);
    body(0);
    for (auto& th : pool) th.join();
}

// ---- categorical vocab lookup: tiny vocabs (the norm here) beat a hash.
// Small-vocab entries of <=8 bytes compare as ONE masked uint64 (length +
// word equality) instead of a memcmp call per candidate.
struct Vocab {
    struct Entry {
        uint64_t key = 0;       // first <=8 bytes, zero-padded (len <= 8)
        uint32_t len = 0;
        std::string_view full;  // for len > 8 comparisons
    };
    std::vector<Entry> entries;  // linear scan when small
    std::unordered_map<std::string_view, int32_t> map;  // else
    bool small = true;

    void build(const char** vocab, int n) {
        small = n <= 8;
        if (small) {
            entries.resize(static_cast<size_t>(n));
            for (int i = 0; i < n; ++i) {
                Entry& e = entries[static_cast<size_t>(i)];
                e.full = std::string_view(vocab[i]);
                e.len = static_cast<uint32_t>(e.full.size());
                std::memcpy(&e.key, e.full.data(),
                            e.len < 8 ? e.len : 8);
            }
        } else {
            map.reserve(static_cast<size_t>(n) * 2);
            for (int i = 0; i < n; ++i)
                map.emplace(std::string_view(vocab[i]), i);
        }
    }
    int32_t find(std::string_view v, const char* hard_end) const {
        if (!small) {
            auto it = map.find(v);
            return it == map.end() ? -1 : it->second;
        }
        const uint32_t vl = static_cast<uint32_t>(v.size());
        if (vl <= 8) {
            const uint64_t w = load8_masked(v.data(), vl, hard_end);
            for (size_t i = 0; i < entries.size(); ++i)
                if (entries[i].len == vl && entries[i].key == w)
                    return static_cast<int32_t>(i);
            return -1;
        }
        for (size_t i = 0; i < entries.size(); ++i)
            if (entries[i].len == vl
                && std::memcmp(entries[i].full.data(), v.data(), vl) == 0)
                return static_cast<int32_t>(i);
        return -1;
    }
};

constexpr int KIND_NUMERIC = 1;
constexpr int KIND_CATEGORICAL = 2;
constexpr int KIND_STRING = 3;
// presence check only: counts short rows like KIND_STRING but builds no
// blob — the Python side defers string materialization to first access
// (NB/RF training never reads the id column; at 100M rows skipping the
// blob build/join/copy at load time is worth ~25% of the fill pass)
constexpr int KIND_STRING_CHECK = 4;
// numeric field that ALSO emits its bin code (floor(v / bucketWidth) -
// binOffset, the ColumnarTable.binned_codes contract) during the same
// parse: the host-side float64 floor-divide pass measured ~0.2 s per
// column per 10M rows of NB-train prep, pure re-walk of parsed data
constexpr int KIND_NUMERIC_BINNED = 5;

struct Spec {
    int32_t ordinal = 0;
    int32_t kind = 0;
    void* out = nullptr;  // double* / int32_t*; unused for string
    int str_idx = -1;     // index among string columns (fill-call order)
    int bad_idx = 0;      // index into the caller's bad-count array
    Vocab vocab;          // categorical only
    int32_t* bin_out = nullptr;  // KIND_NUMERIC_BINNED only
    double bin_width = 1.0;
    int32_t bin_offset = 0;
};

// Fused fill of every requested column over rows [row_lo, row_hi) of the
// line index, writing OUTPUT-RELATIVE indices (row r lands at r - row_lo).
// The whole-file avt_fill is the (0, n) case; avt_fill_range exposes the
// row-block form for the streaming ingest pipeline (a background thread
// parses block i+1 while block i is in flight to the device).
// row_bad (nullable): caller-zeroed span-length uint8 buffer; row o gets 1
// when ANY requested field of that row was missing or failed numeric parse
// — the per-row malformed-record report the skip/quarantine bad-record
// policies filter on (threads write disjoint output rows, so the plain
// stores race-free).
int64_t fill_range(Handle* h, int64_t row_lo, int64_t row_hi, int n_cols,
                   const int32_t* ords, const int32_t* kinds, void** outs,
                   const char*** vocabs, const int32_t* vocab_ns,
                   int64_t* bad_out, void** bin_outs,
                   const double* bin_widths,
                   const int32_t* bin_offsets,
                   uint8_t* row_bad) try {
    const int64_t span = row_hi - row_lo;
    const char delim = h->delim;
    const char* buf = h->data;
    const char* hard_end = buf + h->size;

    std::vector<Spec> specs(static_cast<size_t>(n_cols));
    int n_str = 0;
    for (int i = 0; i < n_cols; ++i) {
        Spec& s = specs[static_cast<size_t>(i)];
        s.ordinal = ords[i];
        s.kind = kinds[i];
        s.out = outs[i];
        s.bad_idx = i;
        s.str_idx = (s.kind == KIND_STRING) ? n_str++ : -1;
        if (s.kind == KIND_CATEGORICAL)
            s.vocab.build(vocabs[i], vocab_ns[i]);
        if (s.kind == KIND_NUMERIC_BINNED) {
            s.bin_out = static_cast<int32_t*>(bin_outs[i]);
            s.bin_width = bin_widths[i];
            s.bin_offset = bin_offsets[i];
        }
    }
    std::sort(specs.begin(), specs.end(),
              [](const Spec& a, const Spec& b) {
                  return a.ordinal < b.ordinal;
              });

    // a small AUTO-threaded block does not amortize thread spawn: one
    // shard under ~256k rows.  An EXPLICIT n_threads still shards even
    // tiny spans — that is how tests exercise the multi-shard merge.
    int T = h->n_threads;
    if (!h->explicit_threads && span < (1 << 18)) T = 1;
    // per-thread: bad counts, string bytes, per-row string lengths
    std::vector<std::vector<int64_t>> t_bad(
        static_cast<size_t>(T),
        std::vector<int64_t>(static_cast<size_t>(n_cols), 0));
    std::vector<std::vector<std::string>> t_blob(
        static_cast<size_t>(T),
        std::vector<std::string>(static_cast<size_t>(n_str)));
    std::vector<std::vector<std::vector<int32_t>>> t_slen(
        static_cast<size_t>(T),
        std::vector<std::vector<int32_t>>(static_cast<size_t>(n_str)));

    std::atomic<bool> fail{false};
    run_sharded(T, [&](int t) {
        try {
            const int64_t r0 = row_lo + span * t / T;
            const int64_t r1 = row_lo + span * (t + 1) / T;
            auto& bad = t_bad[static_cast<size_t>(t)];
            auto& blobs = t_blob[static_cast<size_t>(t)];
            auto& slens = t_slen[static_cast<size_t>(t)];
            for (auto& v : slens)
                v.reserve(static_cast<size_t>(r1 - r0));
            for (int64_t r = r0; r < r1; ++r) {
                const int64_t o = r - row_lo;  // output-relative row index
                const char* p = buf + h->starts[static_cast<size_t>(r)];
                const char* line_end = p + h->lens[static_cast<size_t>(r)];
                int32_t cur = 0;  // ordinal of the field starting at p
                bool exhausted = false;
                for (const Spec& s : specs) {
                    // advance to the spec's ordinal
                    while (!exhausted && cur < s.ordinal) {
                        const char* q = find_byte(p, line_end, delim,
                                                  hard_end);
                        if (q == nullptr) { exhausted = true; break; }
                        p = q + 1;
                        ++cur;
                    }
                    if (exhausted) {  // short row: missing for this spec
                        ++bad[static_cast<size_t>(s.bad_idx)];
                        if (row_bad != nullptr)
                            row_bad[o] = 1;
                        if (s.kind == KIND_NUMERIC
                            || s.kind == KIND_NUMERIC_BINNED) {
                            static_cast<double*>(s.out)[o] = 0.0;
                            if (s.bin_out != nullptr)  // bin code of 0.0
                                s.bin_out[o] = -s.bin_offset;
                        } else if (s.kind == KIND_CATEGORICAL) {
                            static_cast<int32_t*>(s.out)[o] = -1;
                        } else if (s.kind == KIND_STRING) {
                            slens[static_cast<size_t>(s.str_idx)]
                                .push_back(0);
                        }
                        continue;
                    }
                    const char* q = find_byte(p, line_end, delim,
                                              hard_end);
                    const char* fe = q ? q : line_end;
                    if (s.kind == KIND_NUMERIC
                        || s.kind == KIND_NUMERIC_BINNED) {
                        std::string_view v = trimmed(p, fe - p);
                        bool plus = !v.empty() && v[0] == '+';
                        if (plus)                       // python float()
                            v.remove_prefix(1);         // accepts '+'
                        // ...but never a second sign ('+-1' must stay
                        // invalid: what remains after the strip would
                        // parse as a plain signed number)
                        bool double_sign = plus && !v.empty()
                            && (v[0] == '+' || v[0] == '-');
                        double d = 0.0;
                        if (double_sign
                            || (!parse_simple_number(v, &d)
                                && !parse_general_number(v, &d))) {
                            d = 0.0;
                            ++bad[static_cast<size_t>(s.bad_idx)];
                            if (row_bad != nullptr)
                                row_bad[o] = 1;
                        }
                        static_cast<double*>(s.out)[o] = d;
                        if (s.bin_out != nullptr)
                            // == numpy (col // bucketWidth) - bin_offset
                            s.bin_out[o] = static_cast<int32_t>(
                                np_floor_divide(d, s.bin_width))
                                - s.bin_offset;
                    } else if (s.kind == KIND_CATEGORICAL) {
                        static_cast<int32_t*>(s.out)[o] =
                            s.vocab.find(trimmed(p, fe - p), hard_end);
                    } else if (s.kind == KIND_STRING) {
                        blobs[static_cast<size_t>(s.str_idx)].append(
                            p, static_cast<size_t>(fe - p));
                        slens[static_cast<size_t>(s.str_idx)].push_back(
                            static_cast<int32_t>(fe - p));
                    }  // KIND_STRING_CHECK: presence already verified
                    // leave p at the current field; the next spec advances
                }
            }
        } catch (...) {
            fail.store(true);
        }
    });
    if (fail.load()) return -1;

    for (int i = 0; i < n_cols; ++i) {
        bad_out[i] = 0;
        for (int t = 0; t < T; ++t)
            bad_out[i] += t_bad[static_cast<size_t>(t)]
                               [static_cast<size_t>(i)];
    }

    // join per-thread string pieces (threads cover disjoint ordered row
    // ranges, so concatenation in thread order preserves row order)
    h->str_blobs.assign(static_cast<size_t>(n_str), {});
    h->str_offsets.assign(static_cast<size_t>(n_str), {});
    for (int sidx = 0; sidx < n_str; ++sidx) {
        size_t bytes = 0;
        for (int t = 0; t < T; ++t)
            bytes += t_blob[static_cast<size_t>(t)]
                           [static_cast<size_t>(sidx)].size();
        auto& blob = h->str_blobs[static_cast<size_t>(sidx)];
        auto& offs = h->str_offsets[static_cast<size_t>(sidx)];
        offs.reserve(static_cast<size_t>(span) + 1);
        offs.push_back(0);
        if (T == 1) {  // single shard: adopt the buffer, skip the copy
            blob = std::move(t_blob[0][static_cast<size_t>(sidx)]);
            for (int32_t L : t_slen[0][static_cast<size_t>(sidx)])
                offs.push_back(offs.back() + L);
        } else {
            blob.reserve(bytes);
            for (int t = 0; t < T; ++t) {
                blob += t_blob[static_cast<size_t>(t)]
                              [static_cast<size_t>(sidx)];
                for (int32_t L : t_slen[static_cast<size_t>(t)]
                                       [static_cast<size_t>(sidx)])
                    offs.push_back(offs.back() + L);
            }
        }
    }
    return 0;
} catch (...) {
    return -1;
}

}  // namespace

extern "C" {

// mmap the file and build the non-blank line index (parallel memchr scan).
// Returns an opaque handle, nullptr on IO failure (C++ exceptions must not
// cross the ctypes boundary).  n_threads <= 0 picks hardware concurrency.
void* avt_open(const char* path, char delim, int n_threads) try {
    auto h = std::make_unique<Handle>();
    h->delim = delim;
    h->fd = ::open(path, O_RDONLY);
    if (h->fd < 0) return nullptr;
    struct stat st;
    if (::fstat(h->fd, &st) != 0 || !S_ISREG(st.st_mode))
        return nullptr;  // pipe/special file: no fast path (~Handle closes)
    h->size = static_cast<size_t>(st.st_size);
    if (h->size > 0) {
        void* m = ::mmap(nullptr, h->size, PROT_READ, MAP_PRIVATE, h->fd, 0);
        if (m == MAP_FAILED) return nullptr;  // ~Handle closes the fd once
        ::madvise(m, h->size, MADV_SEQUENTIAL);
        h->data = static_cast<const char*>(m);
    }
    int hw = static_cast<int>(std::thread::hardware_concurrency());
    h->explicit_threads = n_threads > 0;
    int T = n_threads > 0 ? n_threads : (hw > 0 ? hw : 1);
    if (T > 16) T = 16;
    // tiny files: thread spawn costs more than the scan (an EXPLICIT
    // n_threads still sharded — that is how tests exercise the pool)
    if (n_threads <= 0 && h->size < (1u << 22)) T = 1;
    h->n_threads = T;

    // align thread byte ranges to line starts (range i ends where i+1 starts)
    std::vector<size_t> bounds(static_cast<size_t>(T) + 1, h->size);
    bounds[0] = 0;
    for (int t = 1; t < T; ++t)
        bounds[static_cast<size_t>(t)] =
            next_line_start(h->data, h->size,
                            h->size / static_cast<size_t>(T)
                                * static_cast<size_t>(t));
    std::vector<std::vector<int64_t>> t_starts(static_cast<size_t>(T));
    std::vector<std::vector<int32_t>> t_lens(static_cast<size_t>(T));
    std::atomic<bool> fail{false};
    run_sharded(T, [&](int t) {
        try {  // a bad_alloc escaping a std::thread would std::terminate
            size_t lo = bounds[static_cast<size_t>(t)];
            size_t hi = bounds[static_cast<size_t>(t) + 1];
            if (h->size > 0 && lo < hi)
                index_range(h->data, h->size, lo, hi,
                            &t_starts[static_cast<size_t>(t)],
                            &t_lens[static_cast<size_t>(t)]);
        } catch (...) {
            fail.store(true);
        }
    });
    if (fail.load()) return nullptr;
    size_t total = 0;
    for (auto& v : t_starts) total += v.size();
    h->starts.resize(total);
    h->lens.resize(total);
    size_t at = 0;
    for (int t = 0; t < T; ++t) {
        auto& vs = t_starts[static_cast<size_t>(t)];
        auto& vl = t_lens[static_cast<size_t>(t)];
        if (!vs.empty()) {
            std::memcpy(h->starts.data() + at, vs.data(),
                        vs.size() * sizeof(int64_t));
            std::memcpy(h->lens.data() + at, vl.data(),
                        vl.size() * sizeof(int32_t));
        }
        at += vs.size();
    }
    return h.release();
} catch (...) {
    return nullptr;
}

int64_t avt_n_rows(void* hp) {
    return static_cast<int64_t>(static_cast<Handle*>(hp)->starts.size());
}

// Fused fill of every requested column in one pass over the rows.
//   ords/kinds/outs/bad_out: n_cols parallel arrays (kind 1 numeric ->
//   double*, 2 categorical -> int32*, 3 string -> out ignored, 5 numeric
//   + bin code).  vocabs/vocab_ns: per-column vocab (categorical only,
//   else null/0).  bin_outs/bin_widths/bin_offsets: per-column bin-code
//   emission (KIND_NUMERIC_BINNED only, else null/ignored); all three
//   may be null when no column requests binning.
// bad_out[i] counts rows whose field was missing (all kinds) or failed
// numeric parse; unknown categorical values are -1, NOT bad.  row_bad
// (nullable) is a caller-zeroed n-row uint8 buffer reporting WHICH rows
// were malformed (the skip/quarantine policies' filter input).  Returns
// 0, or -1 on allocation failure (caller falls back to the python path).
int64_t avt_fill(void* hp, int n_cols, const int32_t* ords,
                 const int32_t* kinds, void** outs,
                 const char*** vocabs, const int32_t* vocab_ns,
                 int64_t* bad_out, void** bin_outs,
                 const double* bin_widths,
                 const int32_t* bin_offsets, uint8_t* row_bad) {
    auto* h = static_cast<Handle*>(hp);
    return fill_range(h, 0, avt_n_rows(hp), n_cols, ords, kinds, outs,
                      vocabs, vocab_ns, bad_out, bin_outs, bin_widths,
                      bin_offsets, row_bad);
}

// Row-block form of avt_fill: fill rows [row_lo, row_hi) of the line
// index into output buffers of (row_hi - row_lo) rows (row r lands at
// index r - row_lo).  String blobs/offsets (avt_string_blob /
// avt_string_offsets) describe ONLY this block and are overwritten by the
// next fill call on the handle.  Returns 0, -1 on allocation failure, -2
// on an out-of-range row window.
int64_t avt_fill_range(void* hp, int64_t row_lo, int64_t row_hi,
                       int n_cols, const int32_t* ords,
                       const int32_t* kinds, void** outs,
                       const char*** vocabs, const int32_t* vocab_ns,
                       int64_t* bad_out, void** bin_outs,
                       const double* bin_widths,
                       const int32_t* bin_offsets, uint8_t* row_bad) {
    auto* h = static_cast<Handle*>(hp);
    if (row_lo < 0 || row_hi < row_lo || row_hi > avt_n_rows(hp))
        return -2;
    return fill_range(h, row_lo, row_hi, n_cols, ords, kinds, outs,
                      vocabs, vocab_ns, bad_out, bin_outs, bin_widths,
                      bin_offsets, row_bad);
}

// Raw bytes of non-blank line `row` of the index (for quarantining a
// malformed record verbatim).  *len_out = line byte length; returns
// nullptr (len -1) when row is out of range.  Valid while the handle
// lives (points into the mmap).
const char* avt_row_text(void* hp, int64_t row, int64_t* len_out) {
    auto* h = static_cast<Handle*>(hp);
    if (row < 0 || static_cast<size_t>(row) >= h->starts.size()) {
        *len_out = -1;
        return nullptr;
    }
    *len_out = h->lens[static_cast<size_t>(row)];
    return h->data + h->starts[static_cast<size_t>(row)];
}

// String column `str_idx` (fill-call order among string columns): joined
// bytes; *len_out = total byte length.  Valid until the next avt_fill or
// avt_free on this handle.
const char* avt_string_blob(void* hp, int str_idx, int64_t* len_out) {
    auto* h = static_cast<Handle*>(hp);
    if (str_idx < 0
        || static_cast<size_t>(str_idx) >= h->str_blobs.size()) {
        *len_out = -1;
        return nullptr;
    }
    const std::string& b = h->str_blobs[static_cast<size_t>(str_idx)];
    *len_out = static_cast<int64_t>(b.size());
    return b.data();
}

// n+1 int64 byte offsets into the blob (row i = [offs[i], offs[i+1])).
const int64_t* avt_string_offsets(void* hp, int str_idx) {
    auto* h = static_cast<Handle*>(hp);
    if (str_idx < 0
        || static_cast<size_t>(str_idx) >= h->str_offsets.size())
        return nullptr;
    return h->str_offsets[static_cast<size_t>(str_idx)].data();
}

void avt_free(void* hp) {
    delete static_cast<Handle*>(hp);  // ~Handle munmaps + closes
}

}  // extern "C"
