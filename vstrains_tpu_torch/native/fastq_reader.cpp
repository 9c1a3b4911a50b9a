// Native FASTQ pair loader: parse + filter + 2-bit-style pack, feeding the
// TPU PE-link inference engine.
//
// Replaces the Python readlines() loop of the reference
// (/root/reference/utils/VStrains_PE_Inference.py:147-165) on the host
// data path: at 10M+ read pairs the Python parse dominates wall-clock, so
// this is the framework's native data-loader component (the reference's
// native muscle lived in its deps; ours lives here).
//
// Contract (mirrors core/fastq.py):
//   pair dropped if either mate contains a non-ACGT char other than
//   padding semantics (reference: 'N' check -> here any non-ACGT counts as
//   N), else dropped if either mate shorter than split_len; remaining
//   pairs packed as code arrays (A,C,G,T -> 0..3, pad -> 255).
//
// Built with: g++ -O3 -march=native -shared -fPIC -o libfastq.so
// Loaded via ctypes (vstrains_tpu/native/__init__.py); pure-Python
// fallback stays in core/fastq.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

struct Record {
    const char *seq;
    int64_t len;
};

struct PairFile {
    std::vector<char> fwd_buf, rve_buf;
    std::vector<Record> fwd, rve;
    std::vector<int64_t> keep;  // indices of usable pairs
    int64_t n_reads = 0;        // dropped: contained N / non-ACGT
    int64_t short_reads = 0;    // dropped: shorter than split_len
    int64_t max_flen = 0, max_rlen = 0;
};

// base -> code table; 255 = invalid
uint8_t CODE[256];
struct CodeInit {
    CodeInit() {
        memset(CODE, 255, sizeof(CODE));
        CODE[(unsigned char)'A'] = 0;
        CODE[(unsigned char)'C'] = 1;
        CODE[(unsigned char)'G'] = 2;
        CODE[(unsigned char)'T'] = 3;
    }
} code_init;

bool ends_with_gz(const char *path) {
    size_t n = strlen(path);
    return n >= 3 && memcmp(path + n - 3, ".gz", 3) == 0;
}

bool read_file(const char *path, std::vector<char> &buf) {
    if (ends_with_gz(path)) {
        // gzip-compressed FASTQ (the common on-disk form for real read
        // sets; neither the reference nor plain readlines handles it)
        gzFile g = gzopen(path, "rb");
        if (!g) return false;
        gzbuffer(g, 1 << 20);
        buf.clear();
        std::vector<char> chunk(1 << 22);
        int got;
        while ((got = gzread(g, chunk.data(), chunk.size())) > 0)
            buf.insert(buf.end(), chunk.data(), chunk.data() + got);
        bool ok = got == 0;
        gzclose(g);
        return ok;
    }
    FILE *f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    buf.resize(sz);
    size_t got = fread(buf.data(), 1, sz, f);
    fclose(f);
    return got == (size_t)sz;
}

// collect the sequence line (2nd of each 4-line record)
void collect_records(const std::vector<char> &buf,
                     std::vector<Record> &out) {
    const char *p = buf.data();
    const char *end = p + buf.size();
    int line_in_rec = 0;
    while (p < end) {
        const char *nl = (const char *)memchr(p, '\n', end - p);
        const char *eol = nl ? nl : end;
        if (eol > p && eol[-1] == '\r') eol--;  // tolerate CRLF files
        if (line_in_rec == 1) out.push_back({p, eol - p});
        line_in_rec = (line_in_rec + 1) & 3;
        if (!nl) break;
        p = nl + 1;
    }
}

// reference parity: only 'N' disqualifies a pair
// (PE_Inference.py:160 checks fseq.count("N")); other non-ACGT chars are
// kept but coded 255 so their windows never match.
bool has_N(const Record &r) {
    return memchr(r.seq, 'N', r.len) != nullptr;
}

}  // namespace

extern "C" {

void *fq_open(const char *fwd_path, const char *rve_path,
              int64_t split_len) {
    PairFile *pf = new PairFile();
    if (!read_file(fwd_path, pf->fwd_buf)
        || !read_file(rve_path, pf->rve_buf)) {
        delete pf;
        return nullptr;
    }
    collect_records(pf->fwd_buf, pf->fwd);
    collect_records(pf->rve_buf, pf->rve);
    int64_t total = pf->fwd.size() < pf->rve.size()
                        ? (int64_t)pf->fwd.size()
                        : (int64_t)pf->rve.size();
    for (int64_t i = 0; i < total; i++) {
        const Record &f = pf->fwd[i];
        const Record &r = pf->rve[i];
        if (has_N(f) || has_N(r)) {
            pf->n_reads++;
        } else if (f.len < split_len || r.len < split_len) {
            pf->short_reads++;
        } else {
            pf->keep.push_back(i);
            if (f.len > pf->max_flen) pf->max_flen = f.len;
            if (r.len > pf->max_rlen) pf->max_rlen = r.len;
        }
    }
    return pf;
}

int64_t fq_num_pairs(void *h) { return ((PairFile *)h)->keep.size(); }
int64_t fq_n_reads(void *h) { return ((PairFile *)h)->n_reads; }
int64_t fq_short_reads(void *h) { return ((PairFile *)h)->short_reads; }
int64_t fq_max_flen(void *h) { return ((PairFile *)h)->max_flen; }
int64_t fq_max_rlen(void *h) { return ((PairFile *)h)->max_rlen; }

// fill caller-allocated arrays:
//   fwd_codes: uint8 [num_pairs, tf] pre-filled by caller? no — we fill,
//   padding with 255. lens: int32 [num_pairs].
void fq_fill(void *h, uint8_t *fwd_codes, int32_t *fwd_len,
             uint8_t *rve_codes, int32_t *rve_len, int64_t tf,
             int64_t tr) {
    PairFile *pf = (PairFile *)h;
    int64_t n = pf->keep.size();
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < n; j++) {
        int64_t i = pf->keep[j];
        const Record &f = pf->fwd[i];
        const Record &r = pf->rve[i];
        uint8_t *fo = fwd_codes + j * tf;
        uint8_t *ro = rve_codes + j * tr;
        memset(fo, 255, tf);
        memset(ro, 255, tr);
        for (int64_t x = 0; x < f.len; x++)
            fo[x] = CODE[(unsigned char)f.seq[x]];
        for (int64_t x = 0; x < r.len; x++)
            ro[x] = CODE[(unsigned char)r.seq[x]];
        fwd_len[j] = (int32_t)f.len;
        rve_len[j] = (int32_t)r.len;
    }
}

void fq_close(void *h) { delete (PairFile *)h; }

// Pack one batch of read pairs into the engine's 2-bit wire format
// (see ops/pe_infer._pack_wire_np for the layout contract: per row,
// ceil(T/4) bytes of forward codes, same of reverse codes, then
// fl/rl as little-endian u16). Fuses the in-read bad-code check into
// the packing pass: returns 0 when the batch is representable, -1 when
// any code > 3 sits inside a read (caller must use the byte path).
// Codes past a read's length pack as 0 — such windows are invalidated
// by the device-side length test, so their bits never match.
static int pack_one_end(const uint8_t *src, int64_t len, int64_t T4,
                        uint8_t *dst) {
    int bad = 0;
    int64_t full = len / 4;  // blocks wholly inside the read
    for (int64_t b = 0; b < full; b++) {
        const uint8_t *s = src + 4 * b;
        uint8_t c0 = s[0], c1 = s[1], c2 = s[2], c3 = s[3];
        bad |= (c0 | c1 | c2 | c3) > 3;
        dst[b] = (uint8_t)((c0 & 3) | ((c1 & 3) << 2) | ((c2 & 3) << 4)
                           | ((c3 & 3) << 6));
    }
    for (int64_t b = full; b < T4; b++) {
        uint8_t v = 0;
        for (int64_t q = 0; q < 4; q++) {
            int64_t x = 4 * b + q;
            if (x < len) {
                uint8_t c = src[x];
                if (c > 3) { bad = 1; c = 0; }
                v |= (uint8_t)((c & 3) << (2 * q));
            }
        }
        dst[b] = v;
    }
    return bad;
}

int64_t wire_pack(const uint8_t *fc, const int32_t *fl,
                  const uint8_t *rc, const int32_t *rl, int64_t B,
                  int64_t tf, int64_t tr, int64_t T, uint8_t *out) {
    int64_t T4 = (T + 3) / 4;
    int64_t W = 2 * T4 + 4;
    int any_bad = 0;
#pragma omp parallel for schedule(static) reduction(|:any_bad)
    for (int64_t j = 0; j < B; j++) {
        uint8_t *row = out + j * W;
        any_bad |= pack_one_end(fc + j * tf, fl[j], T4, row);
        any_bad |= pack_one_end(rc + j * tr, rl[j], T4, row + T4);
        row[W - 4] = (uint8_t)(fl[j] & 0xFF);
        row[W - 3] = (uint8_t)((fl[j] >> 8) & 0xFF);
        row[W - 2] = (uint8_t)(rl[j] & 0xFF);
        row[W - 1] = (uint8_t)((rl[j] >> 8) & 0xFF);
    }
    return any_bad ? -1 : 0;
}

}  // extern "C"
