// C++ libsvm line parser — the throughput path of the fm_parser contract.
//
// The reference implements batch text->CSR parsing as a multithreaded C++
// TensorFlow custom op (upstream cc/fm_parser.cc; SURVEY.md §2). This is
// the same job as a dependency-free shared object driven through ctypes
// (fast_tffm_tpu/data/cparser.py): a newline-separated blob of
//     <label> <fid>[:<fval>] ...            (FM)
//     <label> <field>:<fid>[:<fval>] ...    (FFM, field_aware mode)
// lines in, CSR arrays out. Semantics must match the Python parser
// (fast_tffm_tpu/data/parser.py) bit-for-bit — including MurmurHash64A
// feature hashing — and golden tests (tests/test_cparser.py) enforce it.
//
// Parallelism: lines are sliced into contiguous ranges, one thread per
// range parsing into private buffers, stitched in order afterwards, so
// output ordering is identical to single-threaded parsing.

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// MurmurHash64A (Austin Appleby, public domain), seed 0 — must match
// fast_tffm_tpu/data/hashing.py (golden tests pin both).
uint64_t murmur64(const char* key, size_t len, uint64_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const unsigned char* data = reinterpret_cast<const unsigned char*>(key);
  const size_t nblocks = len / 8;
  for (size_t i = 0; i < nblocks; i++) {
    uint64_t k;
    std::memcpy(&k, data + i * 8, 8);
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  const unsigned char* tail = data + nblocks * 8;
  uint64_t t = 0;
  switch (len & 7) {
    case 7: t ^= uint64_t(tail[6]) << 48; [[fallthrough]];
    case 6: t ^= uint64_t(tail[5]) << 40; [[fallthrough]];
    case 5: t ^= uint64_t(tail[4]) << 32; [[fallthrough]];
    case 4: t ^= uint64_t(tail[3]) << 24; [[fallthrough]];
    case 3: t ^= uint64_t(tail[2]) << 16; [[fallthrough]];
    case 2: t ^= uint64_t(tail[1]) << 8; [[fallthrough]];
    case 1:
      t ^= uint64_t(tail[0]);
      h ^= t;
      h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

struct ShardOut {
  std::vector<float> labels;
  std::vector<int32_t> sizes;  // per-example nnz
  std::vector<int32_t> ids;
  std::vector<float> vals;
  std::vector<int32_t> fields;   // field-aware (FFM) mode only
  std::vector<int64_t> linenos;  // per-example line number (filled only
                                 // when keep_linenos; base = caller's
                                 // first_lineno convention)
  int64_t lines_scanned = 0;  // lines walked by parse_range (left 0 on
                              // a parse failure; callers fall back)
  bool failed = false;
  // Error site, kept as (lineno, message) instead of preformatted text
  // so parse_threaded can rebase shard-relative linenos after the join
  // (shards must not pre-scan for absolute offsets — see there).
  int64_t error_lineno = 0;
  std::string error_msg;
};

// Byte class table for the separator test: one L1-resident load beats
// the 5-way compare chain in the token-scan loops (measured 1.4x on a
// scan-only microbench; the full-parse effect is a few percent, inside
// this environment's ambient noise — kept because the scan loops are
// the host throughput ceiling and the semantics are byte-identical).
// Set bytes: \t \v \f \r and space. parser.WHITESPACE is this set PLUS
// \n (Python strips whole decoded lines); here \n must stay 0 — the
// C++ paths split on it as the LINE terminator first, and marking it a
// token separator would silently merge lines.
static const uint8_t kWsTable[256] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 1 /*\t*/, 0 /*\n*/, 1 /*\v*/, 1 /*\f*/,
    1 /*\r*/, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1 /*space*/};

inline bool is_ws(char c) {
  return kWsTable[static_cast<unsigned char>(c)] != 0;
}

// Slow-path float parse via strtod + float cast. Double-then-float
// rounding matches the Python parser's float(token) -> np.float32 exactly
// (strtof's direct-to-float rounding can differ in double-rounding
// corners, so the double route is the parity-correct one).
//
// Lexical grammar is pinned to PYTHON's float() (the golden-parity
// contract), which is narrower than strtod's: no hex floats ("0x10"),
// no "nan(chars)" payloads — only decimal literals and the inf/infinity/
// nan words. Overflow reads as +-inf like Python (strtod flags ERANGE);
// underflow reads as a denormal/0 like Python (ERANGE ignored there).
bool parse_float_slow(const char* begin, const char* end, float* out) {
  char buf[64];
  size_t n = size_t(end - begin);
  if (n >= sizeof(buf) || n == 0) return false;
  bool word_ok = false;  // [+-]?(inf|infinity|nan), case-insensitive
  {
    const char* p = begin;
    if (*p == '+' || *p == '-') p++;
    char low[16];
    size_t m = size_t(end - p);
    if (m > 0 && m < sizeof(low)) {
      for (size_t i = 0; i < m; i++) {
        low[i] = char(std::tolower((unsigned char)p[i]));
      }
      low[m] = '\0';
      word_ok = !std::strcmp(low, "inf") || !std::strcmp(low, "infinity") ||
                !std::strcmp(low, "nan");
    }
  }
  if (!word_ok) {
    for (const char* p = begin; p < end; p++) {
      char c = *p;
      if (!((c >= '0' && c <= '9') || c == '.' || c == '+' || c == '-' ||
            c == 'e' || c == 'E')) {
        return false;  // hex floats, nan payloads, garbage
      }
    }
  }
  std::memcpy(buf, begin, n);
  buf[n] = '\0';
  char* endp = nullptr;
  errno = 0;
  double v = std::strtod(buf, &endp);
  if (endp != buf + n) return false;
  *out = float(v);
  return true;
}

// Exact powers of ten for the simple-decimal fast paths: mantissa /
// 10^frac is one correctly-rounded double op (mantissa exact in 2^53,
// powers exact up to 1e22), equal to Python's float(token).
static const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
    1e22};

// Parse one whitespace-delimited token as float; matches Python float()
// -> float32 on all inputs. Returns false on garbage/empty.
//
// Fast path: plain decimals (the overwhelming case in libsvm data,
// "1.374", "0.83", "1") with <= 15 digits and <= 22 fractional digits
// (see kPow10). strtod/strtof dominate parse time otherwise
// (~100ns/token, 40 tokens/line at Criteo shapes).
inline bool parse_float(const char* begin, const char* end, float* out) {
  if (begin == end) return false;
  const char* p = begin;
  bool neg = false;
  if (*p == '+' || *p == '-') {
    neg = (*p == '-');
    p++;
  }
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  bool any = false, dot = false, simple = true;
  for (; p < end; p++) {
    char c = *p;
    if (c >= '0' && c <= '9') {
      any = true;
      if (digits < 15) {
        mant = mant * 10 + uint64_t(c - '0');
        if (mant) digits++;  // leading zeros are free
        if (dot) frac++;
      } else {
        simple = false;
        break;
      }
    } else if (c == '.' && !dot) {
      dot = true;
    } else {
      simple = false;  // exponent / inf / nan / garbage -> slow path
      break;
    }
  }
  if (simple && any && frac <= 22) {
    double v = double(mant) / kPow10[frac];
    *out = float(neg ? -v : v);
    return true;
  }
  return parse_float_slow(begin, end, out);
}

// 0 = parsed; 1 = not integer syntax; 2 = integer syntax but > 18
// significant digits (magnitude beyond any vocab/field range — callers
// must report it as OUT OF RANGE, not non-integer, to match Python's
// arbitrary-precision int() + range check).
inline int parse_int_status(const char* begin, const char* end,
                            int64_t* out) {
  if (begin == end) return 1;
  const char* p = begin;
  bool neg = false;
  if (*p == '+' || *p == '-') {
    neg = (*p == '-');
    p++;
  }
  if (p == end) return 1;
  uint64_t v = 0;
  int digits = 0;
  bool over = false;
  for (; p < end; p++) {
    char c = *p;
    if (c < '0' || c > '9') return 1;
    if (!over) {
      v = v * 10 + uint64_t(c - '0');
      // Significant digits only: zero-padded ids ("000...05") must
      // parse like Python int(). 18 significant digits can't overflow.
      if (v && ++digits > 18) over = true;
    }
  }
  if (over) return 2;
  *out = neg ? -int64_t(v) : int64_t(v);
  return 0;
}

// Python-int repr of an integer-syntax token span: sign only when
// negative and nonzero, leading zeros stripped — what Python's
// f"{int(s)}" renders in range-error messages, valid for spans that
// overflowed int64 too.
inline std::string canon_int(const char* begin, const char* end) {
  const char* p = begin;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) {
    neg = (*p == '-');
    p++;
  }
  while (p < end && *p == '0') p++;
  if (p == end) return "0";
  return (neg ? "-" : "") + std::string(p, end);
}

void fail(ShardOut* out, int64_t lineno, const std::string& msg) {
  out->failed = true;
  out->error_lineno = lineno;
  out->error_msg = msg;
}

// "line N: msg" — the one rendering of a shard's error site.
std::string shard_error(const ShardOut& o) {
  return "line " + std::to_string(o.error_lineno) + ": " + o.error_msg;
}

// One feature token parsed. FM: `fid[:val]`; field-aware (FFM):
// `field:fid[:val]`. Mirrors parser.py's tok.split(":") handling
// exactly, including error wording (golden tests pin output parity).
struct Token {
  int32_t row;
  int32_t field;  // field-aware only
  float val;
};

// Single-pass fast path for the dominant token shapes in every parse
// mode: `<int fid>[:<simple decimal>]` (FM), the same with a hashed
// string fid (any non-ws, non-colon bytes), and the field-aware
// `<int field>:<fid>[:<simple decimal>]` (FFM, hashed or not). Parses
// WHILE scanning — the general path walks the token bytes twice
// (scan_token for structure, then parse_int/parse_float/murmur over
// the same ranges), and this loop is the host throughput ceiling.
// Returns 1 with (*tok_end_out, *t) filled on success; 0 for ANYTHING
// unusual (sign, exponent, surplus colon, out-of-range field/id,
// empty id, overlong) — the caller then runs the general scan+parse
// path, which owns all error semantics, so the two paths cannot
// disagree on what's accepted (golden + property tests pin that).
inline int try_fast_token(const char* q, const char* line_end,
                          int64_t vocab, bool hash_ids, bool field_aware,
                          int64_t field_num, const char** tok_end_out,
                          Token* t) {
  const char* p = q;
  if (field_aware) {
    uint64_t fld = 0;
    int fdigs = 0;
    while (p < line_end) {
      const char c = *p;
      if (c < '0' || c > '9') break;
      fld = fld * 10 + uint64_t(c - '0');
      if (fld && ++fdigs > 9) return 0;  // overlong field: general path
      p++;
    }
    // Needs digits then ':' (sign, string field, bare token: fall back)
    if (p == q || p >= line_end || *p != ':') return 0;
    if (fld >= uint64_t(field_num)) return 0;  // general path raises
    t->field = int32_t(fld);
    p++;
  } else {
    t->field = 0;
  }
  if (hash_ids) {
    const char* id0 = p;
    while (p < line_end && !is_ws(*p) && *p != ':') p++;
    if (p == id0) return 0;  // empty id: general path owns acceptance
    t->row = int32_t(murmur64(id0, size_t(p - id0), 0) % uint64_t(vocab));
  } else {
    const char* id0 = p;
    uint64_t fid = 0;
    int digs = 0;
    while (p < line_end) {
      const char c = *p;
      if (c < '0' || c > '9') break;
      fid = fid * 10 + uint64_t(c - '0');
      if (fid && ++digs > 18) return 0;
      p++;
    }
    if (p == id0) return 0;  // no digits (sign, string id, ...)
    if (fid >= uint64_t(vocab)) return 0;  // general path raises
    t->row = int32_t(fid);
  }
  if (p >= line_end || is_ws(*p)) {
    t->val = 1.0f;
  } else if (*p == ':') {
    p++;
    uint64_t mant = 0;
    int vdigs = 0, frac = 0;
    bool dot = false, any = false;
    while (p < line_end) {
      const char c = *p;
      if (c >= '0' && c <= '9') {
        any = true;
        if (vdigs >= 15) return 0;
        mant = mant * 10 + uint64_t(c - '0');
        if (mant) vdigs++;
        if (dot) frac++;
      } else if (c == '.' && !dot) {
        dot = true;
      } else {
        break;
      }
      p++;
    }
    if (p < line_end && !is_ws(*p)) return 0;  // exponent, ':', garbage
    if (!any || frac > 22) return 0;
    t->val = float(double(mant) / kPow10[frac]);
  } else {
    return 0;  // id runs into non-digit, non-colon, non-ws bytes
  }
  *tok_end_out = p;
  return 1;
}

// Scan one whitespace-delimited token, recording its first two colons
// and whether more exist — one pass shared with token-boundary
// detection (the parse loops are the host throughput ceiling; the
// bytes must not be walked twice).
inline const char* scan_token(const char* q, const char* line_end,
                              const char** c1, const char** c2,
                              bool* extra) {
  *c1 = *c2 = nullptr;
  *extra = false;
  const char* s = q;
  while (s < line_end && !is_ws(*s)) {
    if (*s == ':') {
      if (*c1 == nullptr) *c1 = s;
      else if (*c2 == nullptr) *c2 = s;
      else *extra = true;
    }
    s++;
  }
  return s;  // tok_end
}

// Returns 0 ok, 1 parse error (message in *err). c1/c2/extra come from
// scan_token over [q, tok_end).
inline int parse_token(const char* q, const char* tok_end,
                       const char* c1, const char* c2, bool extra,
                       int64_t vocab, bool hash_ids, bool field_aware,
                       int64_t field_num, Token* t, std::string* err) {
  const char* fid_begin = q;
  const char* fid_end;
  const char* val_begin = nullptr;  // null = default 1.0
  if (field_aware) {
    if (c1 == nullptr || extra) {
      *err = "bad ffm token '" + std::string(q, tok_end) +
             "' (want field:fid[:val])";
      return 1;
    }
    int64_t fld = 0;
    const int fst = parse_int_status(q, c1, &fld);
    if (fst == 1) {
      *err = "bad field '" + std::string(q, c1) + "'";
      return 1;
    }
    if (fst == 2 || fld < 0 || fld >= field_num) {
      *err = "field " + canon_int(q, c1) + " out of range [0, " +
             std::to_string(field_num) + ")";
      return 1;
    }
    t->field = int32_t(fld);
    fid_begin = c1 + 1;
    fid_end = c2 ? c2 : tok_end;
    if (c2) val_begin = c2 + 1;
  } else {
    if (c2 != nullptr || extra) {
      *err = "bad token '" + std::string(q, tok_end) + "' (want fid[:val])";
      return 1;
    }
    t->field = 0;
    fid_end = c1 ? c1 : tok_end;
    if (c1) val_begin = c1 + 1;
  }
  if (hash_ids) {
    t->row = int32_t(murmur64(fid_begin, size_t(fid_end - fid_begin), 0) %
                     uint64_t(vocab));
  } else {
    int64_t fid = 0;
    const int st = parse_int_status(fid_begin, fid_end, &fid);
    if (st == 1) {
      *err = "non-integer feature id '" + std::string(fid_begin, fid_end) +
             "' (set hash_feature_id = True for string ids)";
      return 1;
    }
    if (st == 2 || fid < 0 || fid >= vocab) {
      *err = "feature id " + canon_int(fid_begin, fid_end) +
             " out of range [0, " + std::to_string(vocab) + ")";
      return 1;
    }
    t->row = int32_t(fid);
  }
  t->val = 1.0f;
  if (val_begin != nullptr && !parse_float(val_begin, tok_end, &t->val)) {
    *err = "bad value '" + std::string(val_begin, tok_end) + "'";
    return 1;
  }
  return 0;
}

// Parse lines [begin, end) of the blob (byte offsets of line starts are
// implicit: we scan). `first_lineno` seeds the per-example line numbers
// (and error messages). `keep_empty` turns blank lines into
// zero-feature label-0 examples (the BatchBuilder's predict-alignment
// mode); otherwise blanks are dropped. `keep_linenos` fills the
// per-example linenos vector — only the streaming-builder feed reads
// it, and this loop is the host throughput ceiling, so the block-parse
// path must not pay the per-example push.
void parse_range(const char* blob, const char* end, int64_t first_lineno,
                 int64_t vocab, bool hash_ids, bool field_aware,
                 int64_t field_num, int max_feats, bool keep_empty,
                 bool keep_linenos, ShardOut* out) {
  const char* p = blob;
  int64_t lineno = first_lineno;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', size_t(end - p)));
    if (line_end == nullptr) line_end = end;
    const char* q = p;
    while (q < line_end && is_ws(*q)) q++;
    if (q == line_end) {
      if (keep_empty) {
        out->labels.push_back(0.0f);
        out->sizes.push_back(0);
        if (keep_linenos) out->linenos.push_back(lineno);
      }
      p = line_end + 1;
      lineno++;
      continue;
    }
    // label token
    const char* tok_end = q;
    while (tok_end < line_end && !is_ws(*tok_end)) tok_end++;
    float label;
    if (!parse_float(q, tok_end, &label)) {
      return fail(out, lineno,
                  "bad label '" + std::string(q, tok_end) + "'");
    }
    out->labels.push_back(label);
    int32_t n_feats = 0;
    q = tok_end;
    while (true) {
      while (q < line_end && is_ws(*q)) q++;
      if (q >= line_end) break;
      Token t;
      if (max_feats > 0 && n_feats >= max_feats) {
        // Python breaks out at the cap without validating the tail of
        // the line; skipping (not erroring) matches that. Only the
        // token boundary matters here, not its structure.
        while (q < line_end && !is_ws(*q)) q++;
        continue;
      }
      if (!try_fast_token(q, line_end, vocab, hash_ids, field_aware,
                          field_num, &tok_end, &t)) {
        const char* c1;
        const char* c2;
        bool extra;
        tok_end = scan_token(q, line_end, &c1, &c2, &extra);
        std::string err;
        if (parse_token(q, tok_end, c1, c2, extra, vocab, hash_ids,
                        field_aware, field_num, &t, &err)) {
          return fail(out, lineno, err);
        }
      }
      out->ids.push_back(t.row);
      out->vals.push_back(t.val);
      if (field_aware) out->fields.push_back(t.field);
      n_feats++;
      q = tok_end;
    }
    out->sizes.push_back(n_feats);
    if (keep_linenos) out->linenos.push_back(lineno);
    p = line_end + 1;
    lineno++;
  }
  out->lines_scanned = lineno - first_lineno;
}

// Slice [blob, end) into <= T line-aligned ranges and parse them on T
// threads. Returns the shard outputs in order. Shared by fm_parse_block
// and the threaded BatchBuilder feed path.
std::vector<ShardOut> parse_threaded(const char* blob, const char* end,
                                     int64_t first_lineno, int T,
                                     int64_t vocab, bool hash_ids,
                                     bool field_aware, int64_t field_num,
                                     int max_feats, bool keep_empty,
                                     bool keep_linenos) {
  const int64_t blob_len = end - blob;
  std::vector<const char*> starts{blob};
  for (int t = 1; t < T; t++) {
    const char* target = blob + blob_len * t / T;
    if (target <= starts.back()) continue;
    const char* nl = static_cast<const char*>(
        std::memchr(target, '\n', size_t(end - target)));
    const char* start = nl ? nl + 1 : end;
    if (start > starts.back()) starts.push_back(start);
  }
  starts.push_back(end);
  int shards = int(starts.size()) - 1;

  std::vector<ShardOut> outs(static_cast<size_t>(shards));
  if (shards == 1) {
    parse_range(starts[0], starts[1], first_lineno, vocab, hash_ids,
                field_aware, field_num, max_feats, keep_empty,
                keep_linenos, &outs[0]);
    return outs;
  }
  // Shards past the first parse with RELATIVE linenos (base 0) and are
  // rebased after the join from the earlier shards' lines_scanned —
  // the alternative (pre-scanning [starts[0], starts[N-1]) for
  // newlines to seed absolute offsets) is a serial O(blob) walk on the
  // calling thread before any parse thread starts, an Amdahl cap on
  // exactly the loop this parallelism exists to speed up.
  std::vector<std::thread> threads;
  for (int s = 0; s < shards; s++) {
    threads.emplace_back(parse_range, starts[size_t(s)],
                         starts[size_t(s) + 1],
                         s == 0 ? first_lineno : 0, vocab,
                         hash_ids, field_aware, field_num, max_feats,
                         keep_empty, keep_linenos, &outs[size_t(s)]);
  }
  for (auto& th : threads) th.join();
  // Rebase: shard s's absolute base = first_lineno + lines before it.
  // A failed shard's lines_scanned is 0/partial, but every shard after
  // the first failure is dropped by both consumers (stitch and feed
  // break at the failed shard), so their linenos never surface.
  int64_t base = outs[0].lines_scanned;  // shard 0 is already absolute
  bool dead = outs[0].failed;
  for (int s = 1; s < shards && !dead; s++) {
    ShardOut& o = outs[size_t(s)];
    const int64_t delta = first_lineno + base;
    for (int64_t& ln : o.linenos) ln += delta;
    if (o.failed) {
      o.error_lineno += delta;
      dead = true;
    }
    base += o.lines_scanned;
  }
  return outs;
}

}  // namespace

extern "C" {

// Bumped whenever any exported signature changes. cparser.py refuses a
// .so reporting a different version: the mtime/symbol checks alone
// cannot catch a stale binary whose symbols still exist but whose
// argument layouts moved (silent data corruption, not a load error).
// History: 1 = initial; 2 = field-aware (FFM) params + fields buffers;
// 3 = raw_ids builder mode (dedup=device); 4 = keep_empty builder mode
// (blank line -> zero-feature example; the predict path's line
// alignment); 5 = fm_bb_new num_threads param (threaded streaming
// feed: parallel parse into a pending queue + serial drain); 6 =
// fm_scan_examples (example-boundary scanner for the parallel host
// data plane's per-batch line groups); 7 = fm_parse_block keep_empty
// param (block-parse path for the predict alignment mode — until this
// the BLOCK parser had no blank-line-preserving mode, so every
// tolerant/weighted keep_empty input fell back to the Python parser
// and the tolerant keep_empty shape routed serial).
int64_t fm_abi_version() { return 7; }

// Scan complete lines of [blob, blob+blob_len) until `n_target` lines
// that PRODUCE AN EXAMPLE have been seen. The counting rule must equal
// the BatchBuilder's exactly (is_ws over the same table): a line whose
// bytes are all separator whitespace is blank — skipped by the builder
// unless keep_empty, where every line becomes an example. Returns the
// count found (<= n_target); *consumed_out = bytes through the LAST
// counted line's newline (trailing blanks stay unconsumed — they
// belong to the next group); *lines_out = total lines (blanks
// included) inside those consumed bytes. A trailing partial line is
// never consumed. This is the parallel data plane's group cutter
// (data/pipeline._GroupScanner): memchr-speed, so the coordinator can
// slice per-batch groups without Python ever touching lines.
int64_t fm_scan_examples(const char* blob, int64_t blob_len,
                         int64_t n_target, int keep_empty,
                         int64_t* consumed_out, int64_t* lines_out) {
  const char* p = blob;
  const char* end = blob + blob_len;
  int64_t found = 0, lines = 0;
  int64_t mark = 0, mark_lines = 0;  // end of the last COUNTED line
  while (p < end && found < n_target) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', size_t(end - p)));
    if (nl == nullptr) break;  // partial line: next chunk's problem
    lines++;
    bool counting = keep_empty != 0;
    if (!counting) {
      const char* q = p;
      while (q < nl && is_ws(*q)) q++;
      counting = q != nl;
    }
    if (counting) {
      found++;
      mark = (nl + 1) - blob;
      mark_lines = lines;
    }
    p = nl + 1;
  }
  *consumed_out = mark;
  *lines_out = mark_lines;
  return found;
}

// The auto ("num_threads = 0") parse-thread count, exported so Python
// reports the value this library actually uses instead of re-deriving
// the formula (which would drift silently).
int fm_auto_threads() {
  int T = int(std::min(8u, std::thread::hardware_concurrency()));
  return T < 1 ? 1 : T;
}

// Returns 0 on success. Outputs:
//   labels[n_examples], poses[n_examples+1], ids[nnz], vals[nnz]
//   (+ fields[nnz] when field_aware — FFM `field:fid[:val]` tokens)
// Caller allocates: labels/poses sized for the line count, ids/vals/
// fields for the worst-case token count (cparser.py sizes them from the
// blob). fields_out may be null when !field_aware. `keep_empty` turns
// blank lines into zero-feature label-0 examples (the predict path's
// one-score-per-input-line alignment), same rule as the BatchBuilder.
int fm_parse_block(const char* blob, int64_t blob_len, int64_t vocab,
                   int hash_ids, int field_aware, int64_t field_num,
                   int max_feats, int keep_empty, int num_threads,
                   int64_t* n_examples_out, int64_t* nnz_out,
                   float* labels_out, int32_t* poses_out, int32_t* ids_out,
                   float* vals_out, int32_t* fields_out, char* err_out,
                   int64_t err_cap) {
  if (vocab <= 0) {
    std::snprintf(err_out, size_t(err_cap), "vocabulary_size must be > 0");
    return 1;
  }
  int T = num_threads > 0 ? num_threads : fm_auto_threads();
  if (T < 1) T = 1;
  if (blob_len < (64 << 10)) T = 1;  // small blocks: threading overhead

  std::vector<ShardOut> outs = parse_threaded(
      blob, blob + blob_len, 0, T, vocab, hash_ids != 0, field_aware != 0,
      field_num, max_feats, keep_empty != 0,
      /*keep_linenos=*/false);

  for (const auto& o : outs) {
    if (o.failed) {
      std::snprintf(err_out, size_t(err_cap), "%s",
                    shard_error(o).c_str());
      return 1;
    }
  }

  // Stitch in order.
  int64_t b = 0, z = 0;
  poses_out[0] = 0;
  for (const auto& o : outs) {
    std::memcpy(labels_out + b, o.labels.data(),
                o.labels.size() * sizeof(float));
    std::memcpy(ids_out + z, o.ids.data(), o.ids.size() * sizeof(int32_t));
    std::memcpy(vals_out + z, o.vals.data(), o.vals.size() * sizeof(float));
    if (field_aware != 0 && fields_out != nullptr) {
      std::memcpy(fields_out + z, o.fields.data(),
                  o.fields.size() * sizeof(int32_t));
    }
    for (size_t e = 0; e < o.sizes.size(); e++) {
      poses_out[b + int64_t(e) + 1] =
          poses_out[b + int64_t(e)] + o.sizes[e];
    }
    b += int64_t(o.labels.size());
    z += int64_t(o.ids.size());
  }
  *n_examples_out = b;
  *nnz_out = z;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch builder: raw byte chunks -> one fully padded device batch in a
// single pass (parse + hash + dedup + padded scatter). This is the hot
// host path for throughput training (bench.py): it replaces the Python
// per-line iteration, the str join/encode, np.unique and the fancy-index
// scatter of the generic path. Resumable across feed() calls so the
// caller can stream arbitrary chunk sizes; the dedup hash map is stamped
// per batch (no per-batch clears).
//
// Padding convention: unique slot 0 is RESERVED for pad_id (== vocab);
// real uniques start at slot 1, and padded local_idx cells are 0. (The
// generic Python path pads at slot U-1; both satisfy the documented
// invariant "padding cells point at a slot holding pad_id".)
// ---------------------------------------------------------------------------

struct BatchBuilder {
  int64_t B, L, vocab;
  bool hash_ids;
  bool field_aware = false;  // FFM `field:fid[:val]` tokens
  bool raw_ids = false;      // dedup=device: li holds raw ids, no dedup
  bool keep_empty = false;   // blank line -> zero-feature example
  int64_t field_num = 0;
  int max_feats;
  int64_t max_uniq;  // 0 = unlimited; else batch closes BEFORE exceeding
  int T = 1;         // feed parse threads (1 = the serial in-line path)
  std::vector<float> labels;    // [B]
  std::vector<int32_t> uniq;    // [B*L + 1]
  std::vector<int32_t> li;      // [B*L], default 0 (pad slot)
  std::vector<float> vals;      // [B*L], default 0
  std::vector<int32_t> fields;  // [B*L] (field_aware only), default 0
  std::vector<int32_t> slot;    // dedup table -> slot index
  std::vector<uint32_t> stamp;  // dedup table stamping
  std::vector<uint32_t> line_slots;  // hash slots inserted by current line
  uint32_t cur_stamp = 0;
  uint32_t mask = 0;
  int64_t n_ex = 0;
  int32_t n_uniq = 1;  // slot 0 = pad
  int32_t max_nnz = 0;
  int64_t lineno = 0;
  std::string error;
  // Threaded feed (T > 1): each fed chunk's complete lines are parsed
  // by T threads into this pending CSR queue (the expensive tokenize/
  // float-parse/hash phase); a cheap serial drain then does the
  // order-dependent work (dedup slots, padded scatter, uniq-budget
  // spill). A parse error is DEFERRED: examples before it drain
  // normally and the error surfaces only when consumption reaches it —
  // the exact observable behavior of the serial path.
  std::vector<float> p_labels;
  std::vector<int32_t> p_sizes;
  std::vector<int64_t> p_linenos;
  std::vector<int32_t> p_ids;
  std::vector<float> p_vals;
  std::vector<int32_t> p_fields;
  size_t p_cursor = 0;      // next pending example
  size_t p_nnz = 0;         // its flat ids/vals offset
  bool p_failed = false;
  std::string p_error;
};

namespace {

void bb_reset(BatchBuilder* bb) {
  bb->n_ex = 0;
  bb->n_uniq = 1;
  bb->max_nnz = 0;
  bb->cur_stamp++;
  // Raw mode: padding cells hold the raw pad id (== vocab, the dead
  // row) — there is no "pad slot 0" indirection without a unique table.
  std::fill(bb->li.begin(), bb->li.end(),
            bb->raw_ids ? int32_t(bb->vocab) : 0);
  std::memset(bb->vals.data(), 0, size_t(bb->B * bb->L) * sizeof(float));
  if (bb->field_aware) {
    std::memset(bb->fields.data(), 0,
                size_t(bb->B * bb->L) * sizeof(int32_t));
  }
}

inline int32_t bb_slot(BatchBuilder* bb, int32_t key) {
  uint32_t h = (uint32_t(key) * 2654435761u) & bb->mask;
  for (;;) {
    if (bb->stamp[h] != bb->cur_stamp) {
      bb->stamp[h] = bb->cur_stamp;
      bb->slot[h] = bb->n_uniq;
      bb->uniq[size_t(bb->n_uniq)] = key;
      bb->line_slots.push_back(h);  // for per-line rollback (uniq cap)
      return bb->n_uniq++;
    }
    if (bb->uniq[size_t(bb->slot[h])] == key) return bb->slot[h];
    h = (h + 1) & bb->mask;
  }
}

// Undo the current line's unique insertions. Un-stamping (stamp 0 never
// equals cur_stamp >= 1) is probe-chain-safe: a committed key's probe
// path to its slot runs over slots that were already occupied at its
// insertion time, and the rolled-back slots were all claimed later, so
// they can't sit on any committed path.
inline void bb_rollback_line(BatchBuilder* bb, int32_t saved_uniq) {
  for (uint32_t h : bb->line_slots) bb->stamp[h] = 0;
  bb->n_uniq = saved_uniq;
}

// The unique-budget close-out, shared by the serial feed and the
// threaded drain so the spill protocol (rollback + row scrub + the
// budget error message) has exactly one implementation. Returns 1 when
// the batch closes early (spill — the example stays unconsumed), -1
// when the batch is empty so the example can never fit (error).
inline int bb_budget_close(BatchBuilder* bb, int32_t* irow, float* vrow,
                           int32_t* frow, int32_t nf, int32_t saved_uniq,
                           int64_t lineno, char* err_out,
                           int64_t err_cap) {
  bb_rollback_line(bb, saved_uniq);
  std::memset(irow, 0, size_t(nf) * sizeof(int32_t));
  std::memset(vrow, 0, size_t(nf) * sizeof(float));
  if (frow != nullptr) std::memset(frow, 0, size_t(nf) * sizeof(int32_t));
  if (bb->n_ex == 0) {
    std::snprintf(err_out, size_t(err_cap),
                  "line %lld: single example exceeds the unique-row "
                  "budget %lld; raise uniq_bucket",
                  (long long)lineno, (long long)bb->max_uniq);
    return -1;
  }
  return 1;
}

// Drain pending (threaded-parse) examples into the batch. Returns 1
// when the batch is full or closed early on the unique budget, 0 when
// pending is exhausted with room left, -1 when consumption reaches a
// deferred parse error (message to err_out).
int bb_drain(BatchBuilder* bb, char* err_out, int64_t err_cap) {
  while (bb->n_ex < bb->B) {
    if (bb->p_cursor >= bb->p_sizes.size()) {
      if (bb->p_failed) {
        std::snprintf(err_out, size_t(err_cap), "%s",
                      bb->p_error.c_str());
        return -1;
      }
      return 0;
    }
    const size_t e = bb->p_cursor;
    const int32_t nf = bb->p_sizes[e];
    const int32_t* ids = bb->p_ids.data() + bb->p_nnz;
    const float* vals = bb->p_vals.data() + bb->p_nnz;
    const int32_t* flds =
        bb->field_aware ? bb->p_fields.data() + bb->p_nnz : nullptr;
    float* vrow = bb->vals.data() + bb->n_ex * bb->L;
    int32_t* irow = bb->li.data() + bb->n_ex * bb->L;
    int32_t* frow =
        bb->field_aware ? bb->fields.data() + bb->n_ex * bb->L : nullptr;
    bb->line_slots.clear();
    const int32_t saved_uniq = bb->n_uniq;
    for (int32_t j = 0; j < nf; j++) {
      irow[j] = bb->raw_ids ? ids[j] : bb_slot(bb, ids[j]);
      vrow[j] = vals[j];
      if (frow != nullptr) frow[j] = flds[j];
    }
    if (bb->max_uniq != 0 && bb->n_uniq > bb->max_uniq) {
      return bb_budget_close(bb, irow, vrow, frow, nf, saved_uniq,
                             bb->p_linenos[e], err_out, err_cap);
    }
    bb->labels[size_t(bb->n_ex)] = bb->p_labels[e];
    if (nf > bb->max_nnz) bb->max_nnz = nf;
    bb->n_ex++;
    bb->p_cursor++;
    bb->p_nnz += size_t(nf);
  }
  return 1;
}

// Threaded feed: parse every complete line of the chunk in parallel
// into pending, then drain. Consumes up to the last newline regardless
// of where the batch fills (excess examples wait in pending; deferred
// errors wait for their turn).
int bb_feed_threaded(BatchBuilder* bb, const char* blob, int64_t blob_len,
                     int64_t* consumed_out, char* err_out,
                     int64_t err_cap) {
  *consumed_out = 0;
  int rc = bb_drain(bb, err_out, err_cap);
  if (rc != 0) return rc;  // full from pending alone, or deferred error
  const char* end0 = blob + blob_len;
  // Last complete line: search the final newline from the back.
  const char* last_nl = nullptr;
  for (const char* c = end0 - 1; c >= blob; c--) {
    if (*c == '\n') {
      last_nl = c;
      break;
    }
  }
  if (last_nl == nullptr) return 0;  // no complete line: need more bytes
  const char* end = last_nl + 1;

  bb->p_labels.clear();
  bb->p_sizes.clear();
  bb->p_linenos.clear();
  bb->p_ids.clear();
  bb->p_vals.clear();
  bb->p_fields.clear();
  bb->p_cursor = 0;
  bb->p_nnz = 0;
  bb->p_failed = false;

  // Small feeds (EOF tails, tiny files) don't amortize thread spawns —
  // the same 64 KB cutoff fm_parse_block uses.
  const int T = (end - blob) < (64 << 10) ? 1 : bb->T;
  std::vector<ShardOut> outs = parse_threaded(
      blob, end, bb->lineno + 1, T, bb->vocab, bb->hash_ids,
      bb->field_aware, bb->field_num, bb->max_feats, bb->keep_empty,
      /*keep_linenos=*/true);
  // parse_range already walked every line; reuse its per-shard counts
  // instead of rescanning the chunk's bytes for newlines ([blob, end)
  // is newline-terminated, so lines == newlines). A failed shard
  // leaves lines_scanned partial — fall back to the byte scan there to
  // keep bb->lineno's post-error value unchanged (the stream is dead
  // after the error reaches the consumer, but parity is free).
  bool any_failed = false;
  for (const auto& o : outs) any_failed |= o.failed;
  if (any_failed) {
    for (const char* c = blob; c < end; c++) {
      if (*c == '\n') bb->lineno++;
    }
  } else {
    for (const auto& o : outs) bb->lineno += o.lines_scanned;
  }
  for (const auto& o : outs) {
    // A failed shard still contributes the examples it completed
    // before the error (labels may hold one half-parsed extra entry;
    // sizes is the count of COMPLETE examples).
    const size_t n_ok = o.sizes.size();
    int64_t nnz_ok = 0;
    for (size_t i = 0; i < n_ok; i++) nnz_ok += o.sizes[i];
    bb->p_labels.insert(bb->p_labels.end(), o.labels.begin(),
                        o.labels.begin() + std::ptrdiff_t(n_ok));
    bb->p_sizes.insert(bb->p_sizes.end(), o.sizes.begin(), o.sizes.end());
    bb->p_linenos.insert(bb->p_linenos.end(), o.linenos.begin(),
                         o.linenos.end());
    bb->p_ids.insert(bb->p_ids.end(), o.ids.begin(),
                     o.ids.begin() + std::ptrdiff_t(nnz_ok));
    bb->p_vals.insert(bb->p_vals.end(), o.vals.begin(),
                      o.vals.begin() + std::ptrdiff_t(nnz_ok));
    if (bb->field_aware) {
      bb->p_fields.insert(bb->p_fields.end(), o.fields.begin(),
                          o.fields.begin() + std::ptrdiff_t(nnz_ok));
    }
    if (o.failed) {
      bb->p_failed = true;
      bb->p_error = shard_error(o);
      break;  // later shards' examples come after the error: dropped
    }
  }
  *consumed_out = end - blob;
  return bb_drain(bb, err_out, err_cap);
}

}  // namespace

extern "C" {

void* fm_bb_new(int64_t B, int64_t L, int64_t vocab, int hash_ids,
                int field_aware, int64_t field_num, int raw_ids,
                int keep_empty, int max_feats, int64_t max_uniq,
                int num_threads) {
  if (B <= 0 || L <= 0 || vocab <= 0) return nullptr;
  if (field_aware != 0 && field_num <= 0) return nullptr;
  // raw_ids skips dedup entirely; the fixed-U spill protocol needs the
  // dedup table, so the two are mutually exclusive.
  if (raw_ids != 0 && max_uniq != 0) return nullptr;
  auto* bb = new BatchBuilder();
  bb->B = B;
  bb->L = L;
  bb->vocab = vocab;
  bb->hash_ids = hash_ids != 0;
  bb->field_aware = field_aware != 0;
  bb->raw_ids = raw_ids != 0;
  bb->keep_empty = keep_empty != 0;
  bb->field_num = field_num;
  bb->max_feats = (max_feats > 0 && max_feats < L) ? max_feats : int(L);
  // A single line adds <= max_feats uniques (+ the pad slot), so the cap
  // must exceed that or one line could never fit in an empty batch.
  if (max_uniq != 0 && max_uniq <= bb->max_feats) {
    delete bb;
    return nullptr;
  }
  bb->max_uniq = max_uniq;
  // Thread count for the feed parse phase (0 = auto). T == 1 keeps the
  // original single-pass loop — on a 1-core host the phase-split would
  // only add buffer traffic.
  const int T = num_threads > 0 ? num_threads : fm_auto_threads();
  bb->T = T < 1 ? 1 : T;
  bb->labels.resize(size_t(B));
  bb->uniq.resize(size_t(B * L + 1));
  bb->uniq[0] = int32_t(vocab);  // pad slot
  bb->li.assign(size_t(B * L), bb->raw_ids ? int32_t(vocab) : 0);
  bb->vals.assign(size_t(B * L), 0.0f);
  if (bb->field_aware) bb->fields.assign(size_t(B * L), 0);
  size_t cap = 16;
  while (cap < size_t(B * L) * 2) cap <<= 1;
  bb->mask = uint32_t(cap - 1);
  bb->slot.resize(cap);
  bb->stamp.assign(cap, 0);
  bb->cur_stamp = 1;
  return bb;
}

void fm_bb_free(void* h) { delete static_cast<BatchBuilder*>(h); }

// Parse lines from blob until the batch has B examples or the blob's
// complete lines are exhausted. Only whole lines (ending in '\n') are
// consumed — the caller carries the tail bytes into its next chunk.
// Returns 1 when the batch is full, 0 for "feed me more", -1 on parse
// error (message in err_out).
int fm_bb_feed(void* h, const char* blob, int64_t blob_len,
               int64_t* consumed_out, char* err_out, int64_t err_cap) {
  auto* bb = static_cast<BatchBuilder*>(h);
  if (bb->T > 1) {
    return bb_feed_threaded(bb, blob, blob_len, consumed_out, err_out,
                            err_cap);
  }
  const char* p = blob;
  const char* end = blob + blob_len;
  while (bb->n_ex < bb->B) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', size_t(end - p)));
    if (line_end == nullptr) break;  // partial line: leave for next chunk
    const char* q = p;
    bb->lineno++;
    while (q < line_end && is_ws(*q)) q++;
    if (q == line_end) {
      if (bb->keep_empty) {
        // Blank line -> zero-feature example, label 0 (predict owes one
        // score per input line; the row buffers are already pad/zero).
        bb->labels[size_t(bb->n_ex)] = 0.0f;
        bb->n_ex++;
      }
      p = line_end + 1;
      continue;
    }
    const char* tok_end = q;
    while (tok_end < line_end && !is_ws(*tok_end)) tok_end++;
    float label;
    if (!parse_float(q, tok_end, &label)) {
      std::snprintf(err_out, size_t(err_cap), "line %lld: bad label '%.*s'",
                    (long long)bb->lineno, int(tok_end - q), q);
      return -1;
    }
    float* vrow = bb->vals.data() + bb->n_ex * bb->L;
    int32_t* irow = bb->li.data() + bb->n_ex * bb->L;
    int32_t* frow = bb->field_aware
                        ? bb->fields.data() + bb->n_ex * bb->L
                        : nullptr;
    int n_feats = 0;
    bb->line_slots.clear();
    const int32_t saved_uniq = bb->n_uniq;
    q = tok_end;
    while (true) {
      while (q < line_end && is_ws(*q)) q++;
      if (q >= line_end) break;
      Token t;
      if (n_feats >= bb->max_feats) {  // cap: skip tail like Python
        while (q < line_end && !is_ws(*q)) q++;  // boundary only
        continue;
      }
      if (!try_fast_token(q, line_end, bb->vocab, bb->hash_ids,
                          bb->field_aware, bb->field_num, &tok_end,
                          &t)) {
        const char* c1;
        const char* c2;
        bool extra;
        tok_end = scan_token(q, line_end, &c1, &c2, &extra);
        std::string terr;
        if (parse_token(q, tok_end, c1, c2, extra, bb->vocab,
                        bb->hash_ids, bb->field_aware, bb->field_num, &t,
                        &terr)) {
          std::snprintf(err_out, size_t(err_cap), "line %lld: %s",
                        (long long)bb->lineno, terr.c_str());
          return -1;
        }
      }
      irow[n_feats] = bb->raw_ids ? t.row : bb_slot(bb, t.row);
      vrow[n_feats] = t.val;
      if (frow != nullptr) frow[n_feats] = t.field;
      n_feats++;
      q = tok_end;
    }
    if (bb->max_uniq != 0 && bb->n_uniq > bb->max_uniq) {
      // This line would push the batch past its unique-row budget:
      // roll it back, close the batch early (spill protocol — the line
      // is left unconsumed and opens the next batch). fm_bb_new
      // guarantees a single line always fits an empty batch.
      const int64_t spill_lineno = bb->lineno;
      bb->lineno--;  // will be re-fed
      const int rc = bb_budget_close(bb, irow, vrow, frow, n_feats,
                                     saved_uniq, spill_lineno, err_out,
                                     err_cap);
      if (rc < 0) return -1;
      *consumed_out = p - blob;
      return 1;
    }
    bb->labels[size_t(bb->n_ex)] = label;
    if (n_feats > bb->max_nnz) bb->max_nnz = n_feats;
    bb->n_ex++;
    p = line_end + 1;
  }
  *consumed_out = p - blob;
  return bb->n_ex >= bb->B ? 1 : 0;
}

// Copy the accumulated batch out and reset for the next one.
// labels_out[B], uniq_out[n_uniq] (slot 0 = pad_id), li_out[B*L],
// vals_out[B*L], fields_out[B*L] (field_aware builders only; may be
// null otherwise). Returns n_examples (0 if the batch is empty).
int64_t fm_bb_finish(void* h, float* labels_out, int32_t* uniq_out,
                     int32_t* li_out, float* vals_out, int32_t* fields_out,
                     int64_t* n_uniq_out, int64_t* max_nnz_out) {
  auto* bb = static_cast<BatchBuilder*>(h);
  const int64_t n = bb->n_ex;
  std::memcpy(labels_out, bb->labels.data(), size_t(n) * sizeof(float));
  std::memcpy(uniq_out, bb->uniq.data(),
              size_t(bb->n_uniq) * sizeof(int32_t));
  std::memcpy(li_out, bb->li.data(), size_t(bb->B * bb->L) * sizeof(int32_t));
  std::memcpy(vals_out, bb->vals.data(),
              size_t(bb->B * bb->L) * sizeof(float));
  if (bb->field_aware && fields_out != nullptr) {
    std::memcpy(fields_out, bb->fields.data(),
                size_t(bb->B * bb->L) * sizeof(int32_t));
  }
  *n_uniq_out = bb->n_uniq;
  *max_nnz_out = bb->max_nnz;
  bb_reset(bb);
  return n;
}

}  // extern "C"

extern "C" {

// First-occurrence-order unique + inverse over a batch's feature ids —
// the hot host-side replacement for np.unique(return_inverse=True), which
// is sort-based and dominates batch-build time at Criteo shapes (~320k
// ids -> ~14ms; this open-addressing pass is ~3ms). Order of uniq_out is
// insertion order, which downstream code treats as opaque.
// uniq_out/inverse_out are caller-allocated (nnz and nnz slots).
// Returns the number of unique ids.
int64_t fm_dedup_ids(const int32_t* ids, int64_t nnz, int32_t* uniq_out,
                     int32_t* inverse_out) {
  if (nnz <= 0) return 0;
  size_t cap = 16;
  while (cap < size_t(nnz) * 2) cap <<= 1;
  const uint32_t mask = uint32_t(cap - 1);
  std::vector<int32_t> slot(cap, -1);  // -> index into uniq_out
  int32_t n_uniq = 0;
  for (int64_t i = 0; i < nnz; i++) {
    const int32_t key = ids[i];
    uint32_t h = (uint32_t(key) * 2654435761u) & mask;
    for (;;) {
      const int32_t s = slot[h];
      if (s < 0) {
        slot[h] = n_uniq;
        uniq_out[n_uniq] = key;
        inverse_out[i] = n_uniq;
        n_uniq++;
        break;
      }
      if (uniq_out[s] == key) {
        inverse_out[i] = s;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  return n_uniq;
}

}  // extern "C"
