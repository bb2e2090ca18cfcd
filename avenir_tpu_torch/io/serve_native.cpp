// Native serving data plane (the port's copy of avenir_tpu/io/
// serve_native.cpp): one pass over a drained batch of
// raw wire messages -> message classification, request-id byte ranges,
// trace-field values (the `t=<us>:<0|1>` grammar, exactly), and the
// assembled feature batch written straight into caller-owned reusable
// buffers — float64 columns for the `predict` form (the encode_rows
// contract: numeric encode is f64 so a value half-an-ulp from a tree
// threshold cannot flip branches vs the oracle) and int8 (n, F) pairs for
// the pre-binned `predictq` form (serving/quantized.py wire layout).  On
// the way out, awp_encode_lpush builds the whole variadic RESP LPUSH
// command of a reply batch as ONE buffer for a single sendall.
//
// Fallback contract (the parity rule the differential fuzz pins): the
// parser returns AWP_FALLBACK the moment it sees anything the pure-python
// path might treat differently — a numeric field outside the strict C
// grammar (python float() is laxer: '1_0', unicode digits, 1e999 -> inf),
// a short predict row, a malformed predictq payload, a trace timestamp
// past 18 digits, or a separator-count mismatch.  The caller then re-runs
// the retained python path on the WHOLE batch, so replies and BadRequests
// counts are identical by construction.  Only message-level junk (unknown
// verb, too few tokens) is classified inline as MSG_BAD — python drops
// those without touching any row machinery.
//
// Build: compiled by io/native_wire.py (g++ -O3 -shared -fPIC) into
// build/avenir_tpu_torch/, the io/native_csv.py pattern.  Parse helpers
// (SWAR delimiter scan, masked small-vocab compare, the two-tier number parse) mirror
// io/csv_native.cpp so the two native paths share one set of idioms.

#include <algorithm>
#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// ---- shared parse idioms (csv_native.cpp) ----

inline bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n'
        || c == '\v' || c == '\f';
}

inline uint64_t load8_masked(const char* p, size_t len,
                             const char* hard_end) {
    if (len == 0) return 0;
    uint64_t w = 0;
    if (p + 8 <= hard_end)
        std::memcpy(&w, p, 8);
    else
        std::memcpy(&w, p, len < 8 ? len : 8);
    if (len < 8)
        w &= ~0ull >> (8 * (8 - len));
    return w;
}

inline const char* find_byte(const char* p, const char* end, char c,
                             const char* hard_end) {
    const uint64_t pat = 0x0101010101010101ull
        * static_cast<unsigned char>(c);
    while (p + 8 <= end || (p + 8 <= hard_end && p < end)) {
        uint64_t w;
        std::memcpy(&w, p, 8);
        uint64_t x = w ^ pat;
        uint64_t hit = (x - 0x0101010101010101ull) & ~x
            & 0x8080808080808080ull;
        if (hit) {
            const char* q = p + (__builtin_ctzll(hit) >> 3);
            return q < end ? q : nullptr;
        }
        p += 8;
    }
    for (; p < end; ++p)
        if (*p == c) return p;
    return nullptr;
}

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

// Full float parse for decimals/exponents/inf/nan.  One wire-path extra
// over the csv twin: '(' is rejected up front — strtod and from_chars
// both accept "nan(chars)" where python float() raises, and the wire
// parser must NEVER parse a field the oracle would error on (the reverse
// direction — C rejects, python accepts — is safe: it just falls back).
inline bool parse_general_number(std::string_view v, double* out) {
    for (char c : v)
        if (c == '(') return false;
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
    auto res = std::from_chars(v.data(), v.data() + v.size(), *out);
    return res.ec == std::errc() && res.ptr == v.data() + v.size();
#else
    if (v.empty() || v.size() > 64) return false;
    if (v[0] == '+' || is_space(v[0])) return false;
    for (char c : v)
        if (c == 'x' || c == 'X') return false;
    char buf[65];
    std::memcpy(buf, v.data(), v.size());
    buf[v.size()] = '\0';
    errno = 0;
    char* end = nullptr;
    double d = std::strtod(buf, &end);
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

struct Vocab {
    struct Entry {
        uint64_t key = 0;
        uint32_t len = 0;
        std::string_view full;
    };
    std::vector<Entry> entries;
    std::unordered_map<std::string_view, int32_t> map;
    bool small = true;

    void build(const char* const* vocab, int n) {
        small = n <= 8;
        if (small) {
            entries.resize(static_cast<size_t>(n));
            for (int i = 0; i < n; ++i) {
                Entry& e = entries[static_cast<size_t>(i)];
                e.full = std::string_view(vocab[i]);
                e.len = static_cast<uint32_t>(e.full.size());
                std::memcpy(&e.key, e.full.data(), e.len < 8 ? e.len : 8);
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

// ---- wire-specific pieces ----

// telemetry/reqtrace._FIELD_RE, compiled to C: ^t=(\d+):([01])$
// Returns 1 matched, 0 not-a-trace-field (an ordinary feature value —
// the backward-compat rule), -1 punt-to-python (timestamp
// past 18 digits: python parses arbitrary-width \d+, this parser does
// not pretend to).
inline int parse_trace_field(const char* p, const char* e,
                             int64_t* us, uint8_t* sampled) {
    if (e - p < 5 || p[0] != 't' || p[1] != '=') return 0;
    const char* d = p + 2;
    int64_t acc = 0;
    int nd = 0;
    while (d < e && *d >= '0' && *d <= '9') {
        if (nd >= 18) return -1;
        acc = acc * 10 + (*d - '0');
        ++d;
        ++nd;
    }
    if (nd == 0 || d + 2 != e || *d != ':') return 0;
    if (d[1] != '0' && d[1] != '1') return 0;
    *us = acc;
    *sampled = (d[1] == '1') ? 1 : 0;
    return 1;
}

// telemetry/reqtrace._DEADLINE_RE, compiled to C: ^d=(\d+)$
// Returns 1 matched — a WELL-FORMED deadline field: the
// whole batch punts to python, which owns deadline shedding (the late
// reply, the Broker/LateShed counter).  0 = not a deadline field (an
// ordinary feature value — same backward-compat rule as the trace
// field).  Width does not matter here: any all-digit tail is
// well-formed to python's arbitrary-width \d+, and the action for
// every match is the same fallback.
inline int parse_deadline_field(const char* p, const char* e) {
    if (e - p < 3 || p[0] != 'd' || p[1] != '=') return 0;
    for (const char* d = p + 2; d < e; ++d)
        if (*d < '0' || *d > '9') return 0;
    return 1;
}

// telemetry/reqtrace._MODEL_RE, compiled to C:
// ^m=([A-Za-z0-9_.\-]+)(?::(\d+))?$
// Returns 1 matched — a WELL-FORMED model-routing field: the
// whole batch punts to python, which owns model routing (the router
// dispatch, the Serving/UnknownModel counter, per-model admission).
// 0 = not a model field (ordinary feature value — same backward-compat
// rule as the trace and deadline fields).
inline int parse_model_field(const char* p, const char* e) {
    if (e - p < 3 || p[0] != 'm' || p[1] != '=') return 0;
    const char* d = p + 2;
    int name_len = 0;
    while (d < e) {
        const char c = *d;
        const bool name_ch = (c >= 'A' && c <= 'Z')
            || (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9')
            || c == '_' || c == '.' || c == '-';
        if (!name_ch) break;
        ++d;
        ++name_len;
    }
    if (name_len == 0) return 0;
    if (d == e) return 1;              // m=<name>
    if (*d != ':') return 0;
    ++d;
    if (d == e) return 0;              // m=<name>: — version missing
    for (; d < e; ++d)
        if (*d < '0' || *d > '9') return 0;
    return 1;                          // m=<name>:<digits>
}

// serving/quantized.py wire-int grammar: canonical signed decimal int8 —
// "0" or -?[1-9][0-9]{0,2}, value in [-128, 127].  No "-0", no leading
// zeros, no '+', no whitespace: the golden-bytes pin freezes this form.
inline bool parse_q_int(const char* p, const char* e, int32_t* out) {
    bool neg = false;
    if (p < e && *p == '-') { neg = true; ++p; }
    if (p == e) return false;
    if (*p == '0') {
        if (neg || p + 1 != e) return false;
        *out = 0;
        return true;
    }
    int32_t acc = 0;
    int nd = 0;
    for (; p < e; ++p, ++nd) {
        if (*p < '0' || *p > '9' || nd >= 3) return false;
        acc = acc * 10 + (*p - '0');
    }
    acc = neg ? -acc : acc;
    if (acc < -128 || acc > 127) return false;
    *out = acc;
    return true;
}

constexpr int32_t AWP_OK = 0;
constexpr int32_t AWP_FALLBACK = 1;

constexpr uint8_t MSG_PREDICT = 0;
constexpr uint8_t MSG_PREDICTQ = 1;
constexpr uint8_t MSG_RELOAD = 2;
constexpr uint8_t MSG_BAD = 3;

// column kinds — same numbering as io/native_csv.py's KIND_* subset
constexpr int32_t KIND_NUMERIC = 1;
constexpr int32_t KIND_CATEGORICAL = 2;

struct ColSpec {
    int32_t ordinal = 0;
    int32_t kind = 0;
    void* out = nullptr;
    Vocab vocab;
};

}  // namespace

extern "C" {

// ABI marker: native_wire.py refuses a stale .so whose ABI predates the
// binding (belt over the mtime-based rebuild).
int32_t awp_abi_version() { return 4; }

// Parse one drained batch.  `buf` holds all messages joined by `sep`
// (a byte no wire message may contain — validated here by separator
// count, so an embedded `sep` can only cause a fallback, never a
// mis-split).  Per-message outputs (length n_msgs, caller-allocated):
//   kind_out      0=predict 1=predictq 2=reload 3=bad
//   id_start/len  request-id byte range in `buf` (predict forms only)
//   rid_out       request ids packed '\n'-terminated in message order
//                 (empty entry for reload/bad) — ONE decode+split on the
//                 python side instead of a per-message slice loop;
//                 capacity >= buf_len + n_msgs; length to *rid_out_len
//   trace_us      enqueue timestamp, -1 when the trace field is absent
//   trace_sampled 1 when present AND sampled
//   slot_out      row index within the form's output buffers, -1 if none
// Float-form columns land in `outs` (double* / int32_t* per spec col,
// capacity >= n_msgs rows); predictq rows land row-major in qv_out /
// qc_out (capacity >= n_msgs * q_width).  q_width <= 0 means the serving
// predictor has no pre-binned path: predictq messages classify without
// payload validation (slot -1), exactly like the python path, which only
// decodes when it can serve.  counts[0..2] = n_float, n_q, n_reload.
// Returns AWP_OK, AWP_FALLBACK (re-run the python path on the whole
// batch), or -1 on internal error (treated as fallback by the binding).
int32_t awp_parse(const char* buf, int64_t buf_len, int64_t n_msgs,
                  char sep, char delim,
                  int32_t n_cols, const int32_t* ords,
                  const int32_t* kinds, void* const* outs,
                  const char* const* const* vocabs,
                  const int32_t* vocab_ns,
                  int32_t min_fields,
                  int32_t q_width, int8_t* qv_out, int8_t* qc_out,
                  uint8_t* kind_out, int64_t* id_start, int32_t* id_len,
                  int64_t* trace_us, uint8_t* trace_sampled,
                  int64_t* slot_out, int64_t* counts,
                  char* rid_out, int64_t* rid_out_len) try {
    const char* hard_end = buf + buf_len;
    char* rid_w = rid_out;

    // an embedded `sep` inside ANY message would shift every boundary
    // after it — validate the global count first so that case can only
    // fall back, never mis-split (the last message alone can't shift
    // boundaries, but the count check covers it all the same)
    int64_t n_sep = 0;
    for (const char* q = buf;
         (q = static_cast<const char*>(
              std::memchr(q, sep, static_cast<size_t>(hard_end - q))))
             != nullptr;
         ++q)
        ++n_sep;
    if (n_sep != n_msgs - 1) return AWP_FALLBACK;

    std::vector<ColSpec> specs(static_cast<size_t>(n_cols));
    int32_t max_ord = -1;
    for (int32_t i = 0; i < n_cols; ++i) {
        ColSpec& s = specs[static_cast<size_t>(i)];
        s.ordinal = ords[i];
        s.kind = kinds[i];
        s.out = outs[i];
        if (s.kind == KIND_CATEGORICAL)
            s.vocab.build(vocabs[i], vocab_ns[i]);
        max_ord = std::max(max_ord, s.ordinal);
    }

    counts[0] = counts[1] = counts[2] = 0;
    // reusable per-row field index (start, end) — wire rows are short
    std::vector<std::pair<const char*, const char*>> fields;
    fields.reserve(static_cast<size_t>(std::max(min_fields, 16)));

    const char* p = buf;
    for (int64_t m = 0; m < n_msgs; ++m) {
        const char* msg_end;
        if (m == n_msgs - 1) {
            msg_end = hard_end;
        } else {
            const char* q = find_byte(p, hard_end, sep, hard_end);
            if (q == nullptr) return AWP_FALLBACK;  // fewer seps than msgs
            msg_end = q;
        }
        kind_out[m] = MSG_BAD;
        id_start[m] = 0;
        id_len[m] = 0;
        trace_us[m] = -1;
        trace_sampled[m] = 0;
        slot_out[m] = -1;

        // tokenize the whole message (str.split(delim) semantics: k
        // delimiters -> k+1 tokens, trailing empty token included)
        fields.clear();
        const char* t = p;
        while (true) {
            const char* q = find_byte(t, msg_end, delim, hard_end);
            const char* te = q ? q : msg_end;
            fields.emplace_back(t, te);
            if (q == nullptr) break;
            t = q + 1;
        }
        const size_t n_tok = fields.size();
        std::string_view verb(fields[0].first,
                              static_cast<size_t>(fields[0].second
                                                  - fields[0].first));

        if (verb == "reload") {
            kind_out[m] = MSG_RELOAD;
            ++counts[2];
        } else if (verb == "reward") {
            // online-learning outcome rows (reward,<id>,<value>):
            // python owns reward parsing, the pending-outcome join and
            // the snapshot-gated ack — the native plane declines the
            // whole batch, near-misses included (python judges them)
            return AWP_FALLBACK;
        } else if ((verb == "predict" || verb == "predictq")
                   && n_tok >= 3) {
            const bool quant = (verb.size() == 8);
            id_start[m] = fields[1].first - buf;
            id_len[m] = static_cast<int32_t>(fields[1].second
                                             - fields[1].first);
            // optional trace field at token 2, only when a field remains
            // after it (reqtrace.split_predict's len(parts) >= 4 rule)
            size_t body = 2;
            if (n_tok >= 4) {
                int tr = parse_trace_field(fields[2].first,
                                           fields[2].second,
                                           &trace_us[m],
                                           &trace_sampled[m]);
                if (tr < 0) return AWP_FALLBACK;
                if (tr == 1) body = 3;
            }
            // optional deadline field next (reqtrace.
            // split_predict_deadline's len(parts) >= i+2 rule): a
            // well-formed one punts the batch to python, which owns
            // deadline shedding; a near-miss is an ordinary feature
            if (n_tok >= body + 2
                && parse_deadline_field(fields[body].first,
                                        fields[body].second))
                return AWP_FALLBACK;
            // optional model-routing field next (same rule): a
            // well-formed one punts the batch to python, which owns
            // model routing; a near-miss is an ordinary feature
            if (n_tok >= body + 2
                && parse_model_field(fields[body].first,
                                     fields[body].second))
                return AWP_FALLBACK;
            const size_t n_fields = n_tok - body;
            if (!quant) {
                if (static_cast<int32_t>(n_fields) < min_fields)
                    return AWP_FALLBACK;  // short row: encode_rows raises
                const int64_t slot = counts[0]++;
                for (const ColSpec& s : specs) {
                    const auto& f = fields[body
                                           + static_cast<size_t>(s.ordinal)];
                    std::string_view v = trimmed(f.first,
                                                 f.second - f.first);
                    if (s.kind == KIND_CATEGORICAL) {
                        static_cast<int32_t*>(s.out)[slot] =
                            s.vocab.find(v, hard_end);
                    } else {
                        bool plus = !v.empty() && v[0] == '+';
                        if (plus)
                            v.remove_prefix(1);
                        bool double_sign = plus && !v.empty()
                            && (v[0] == '+' || v[0] == '-');
                        double d = 0.0;
                        if (double_sign
                            || (!parse_simple_number(v, &d)
                                && !parse_general_number(v, &d)))
                            return AWP_FALLBACK;  // python may raise here
                        static_cast<double*>(s.out)[slot] = d;
                    }
                }
                kind_out[m] = MSG_PREDICT;
                slot_out[m] = slot;
            } else {
                // q_width <= 0 (no pre-binned serving path): classified
                // but never decoded, slot -1 — like the python path,
                // which only decodes payloads it can serve
                kind_out[m] = MSG_PREDICTQ;
                if (q_width > 0) {
                    // payload: <width>,<qv...>,<qc...> — exact arity
                    if (n_fields != static_cast<size_t>(1 + 2 * q_width))
                        return AWP_FALLBACK;
                    int32_t w = 0;
                    if (!parse_q_int(fields[body].first,
                                     fields[body].second, &w)
                        || w != q_width)
                        return AWP_FALLBACK;
                    const int64_t slot = counts[1]++;
                    int8_t* qv = qv_out + slot * q_width;
                    int8_t* qc = qc_out + slot * q_width;
                    for (int32_t j = 0; j < 2 * q_width; ++j) {
                        const auto& f = fields[body + 1
                                               + static_cast<size_t>(j)];
                        int32_t val = 0;
                        if (!parse_q_int(f.first, f.second, &val))
                            return AWP_FALLBACK;
                        if (j < q_width)
                            qv[j] = static_cast<int8_t>(val);
                        else
                            qc[j - q_width] = static_cast<int8_t>(val);
                    }
                    slot_out[m] = slot;
                }
            }
        }
        // anything else stays MSG_BAD — python warns + counts, no row
        if (kind_out[m] <= MSG_PREDICTQ && id_len[m] > 0) {
            std::memcpy(rid_w, buf + id_start[m],
                        static_cast<size_t>(id_len[m]));
            rid_w += id_len[m];
        }
        *rid_w++ = '\n';
        p = msg_end + (m == n_msgs - 1 ? 0 : 1);
    }
    *rid_out_len = rid_w - rid_out;
    return AWP_OK;
} catch (...) {
    return -1;
}

// Encode the whole variadic `LPUSH <queue> v1 ... vn` command as ONE
// RESP buffer — byte-identical to io/respq._encode_command(["LPUSH",
// queue, *values]).  `blob` holds the n_values values joined by '\n'
// (a byte no reply line or predict message contains; an embedded one
// makes the separator count mismatch -> nullptr and the caller uses the
// python encoder, so a mis-split can never reach the wire).  Returns a
// malloc'd buffer (caller frees via awp_free_buf) and writes its length
// to out_len; nullptr on mismatch/error.
char* awp_encode_lpush(const char* queue, int32_t queue_len,
                       const char* blob, int64_t blob_len,
                       int64_t n_values, int64_t* out_len) try {
    if (n_values <= 0) return nullptr;
    std::vector<std::pair<const char*, int64_t>> vals;
    vals.reserve(static_cast<size_t>(n_values));
    const char* p = blob;
    const char* end = blob + blob_len;
    while (true) {
        const char* q = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* ve = q ? q : end;
        vals.emplace_back(p, ve - p);
        if (q == nullptr) break;
        p = q + 1;
    }
    if (static_cast<int64_t>(vals.size()) != n_values) return nullptr;

    char head[32];
    int head_n = std::snprintf(head, sizeof(head), "*%lld\r\n",
                               static_cast<long long>(n_values + 2));
    char qhead[32];
    int qhead_n = std::snprintf(qhead, sizeof(qhead), "$%d\r\n",
                                queue_len);
    size_t total = static_cast<size_t>(head_n)
        + 11  /* "$5\r\nLPUSH\r\n" */
        + static_cast<size_t>(qhead_n) + static_cast<size_t>(queue_len)
        + 2;
    char lenbuf[32];
    for (const auto& v : vals) {
        int ln = std::snprintf(lenbuf, sizeof(lenbuf), "$%lld\r\n",
                               static_cast<long long>(v.second));
        total += static_cast<size_t>(ln)
            + static_cast<size_t>(v.second) + 2;
    }
    char* out = static_cast<char*>(std::malloc(total));
    if (out == nullptr) return nullptr;
    char* w = out;
    std::memcpy(w, head, static_cast<size_t>(head_n));
    w += head_n;
    std::memcpy(w, "$5\r\nLPUSH\r\n", 11);
    w += 11;
    std::memcpy(w, qhead, static_cast<size_t>(qhead_n));
    w += qhead_n;
    std::memcpy(w, queue, static_cast<size_t>(queue_len));
    w += queue_len;
    std::memcpy(w, "\r\n", 2);
    w += 2;
    for (const auto& v : vals) {
        int ln = std::snprintf(lenbuf, sizeof(lenbuf), "$%lld\r\n",
                               static_cast<long long>(v.second));
        std::memcpy(w, lenbuf, static_cast<size_t>(ln));
        w += ln;
        std::memcpy(w, v.first, static_cast<size_t>(v.second));
        w += v.second;
        std::memcpy(w, "\r\n", 2);
        w += 2;
    }
    *out_len = static_cast<int64_t>(w - out);
    return out;
} catch (...) {
    return nullptr;
}

void awp_free_buf(char* p) { std::free(p); }

}  // extern "C"
