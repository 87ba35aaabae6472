// seqpack — native host-side sequence kit for barcoder_tpu.
//
// The reference's native surface is third-party (Bowtie's C++ aligner,
// pysam/htslib, pyzstd; SURVEY.md §2). This port moves alignment onto the
// device, which leaves host IO — FASTQ parsing, byte-matrix building,
// 2-bit packing, revcomp — as the hot host loops feeding the device. This
// library implements them in C++ (exposed via ctypes, no pybind11):
//
//   - sp_parse_fastq: one pass over a raw FASTQ buffer → fixed-width read
//     matrix (0-padded) + lengths. Replaces the Python line loop of the
//     reference's readers (heuristicount.py:100-153, distillreads.py:47-87).
//   - sp_encode_codes: ASCII → 2-bit base codes (A0 C1 G2 T3, other 4).
//   - sp_revcomp_ascii: case-preserving reverse complement of a byte matrix.
//   - sp_pack_2bit64: (n, w<=32) code rows → uint64 keys, N-poisoned, the
//     representation the counting engine matches with searchsorted.
//   - sp_count_exact: full barcode-counting hot loop (window slice + flank
//     check + sorted-key binary search) for single-end data — the C++ twin
//     of VectorCounter's numpy path.
//
// Build: g++ -O3 -march=native -shared -fPIC seqpack.cpp -o libseqpack.so
// (driven by barcoder_tpu/native_bridge.py at first use).

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- tables --
static unsigned char CODE_LUT[256];
static unsigned char COMP_LUT[256];
static bool tables_ready = false;

static void init_tables() {
    if (tables_ready) return;
    for (int i = 0; i < 256; i++) { CODE_LUT[i] = 4; COMP_LUT[i] = (unsigned char)i; }
    const char* bases = "ACGT";
    for (int i = 0; i < 4; i++) {
        CODE_LUT[(unsigned char)bases[i]] = (unsigned char)i;
        CODE_LUT[(unsigned char)(bases[i] + 32)] = (unsigned char)i;
    }
    CODE_LUT[(unsigned char)'U'] = 3; CODE_LUT[(unsigned char)'u'] = 3;
    const char* from = "ACGTacgt";
    const char* to   = "TGCAtgca";
    for (int i = 0; i < 8; i++) COMP_LUT[(unsigned char)from[i]] = (unsigned char)to[i];
    tables_ready = true;
}

// ------------------------------------------------------------ fastq parse --
// Parse a complete FASTQ text buffer. Writes up to max_reads sequences into
// out (row-major, max_reads x row_width, zero-padded); lengths[i] holds the
// true read length (reads longer than row_width are truncated into the
// matrix but report their true length). Returns the number of reads parsed,
// or -1 on malformed input (non-'@' record start).
long long sp_parse_fastq(const char* buf, long long buf_len,
                         unsigned char* out, long long* lengths,
                         long long max_reads, long long row_width) {
    long long n = 0;
    long long i = 0;
    while (i < buf_len && n < max_reads) {
        if (buf[i] != '@') {
            // tolerate trailing whitespace/blank lines
            if (buf[i] == '\n' || buf[i] == '\r') { i++; continue; }
            return -1;
        }
        while (i < buf_len && buf[i] != '\n') i++;  // skip header
        i++;
        long long seq_start = i;
        while (i < buf_len && buf[i] != '\n') i++;
        long long seq_len = i - seq_start;
        if (seq_len > 0 && buf[seq_start + seq_len - 1] == '\r') seq_len--;
        long long copy = seq_len < row_width ? seq_len : row_width;
        std::memcpy(out + n * row_width, buf + seq_start, (size_t)copy);
        if (copy < row_width)
            std::memset(out + n * row_width + copy, 0, (size_t)(row_width - copy));
        lengths[n] = seq_len;
        n++;
        i++;
        while (i < buf_len && buf[i] != '\n') i++;  // '+' line
        i++;
        while (i < buf_len && buf[i] != '\n') i++;  // quality line
        i++;
    }
    return n;
}

// Same contract for a bare ".reads" buffer (one sequence per line).
long long sp_parse_reads(const char* buf, long long buf_len,
                         unsigned char* out, long long* lengths,
                         long long max_reads, long long row_width) {
    long long n = 0;
    long long i = 0;
    while (i < buf_len && n < max_reads) {
        long long start = i;
        while (i < buf_len && buf[i] != '\n') i++;
        long long len = i - start;
        if (len > 0 && buf[start + len - 1] == '\r') len--;
        if (len > 0) {
            long long copy = len < row_width ? len : row_width;
            std::memcpy(out + n * row_width, buf + start, (size_t)copy);
            if (copy < row_width)
                std::memset(out + n * row_width + copy, 0, (size_t)(row_width - copy));
            lengths[n] = len;
            n++;
        }
        i++;
    }
    return n;
}

// ------------------------------------------------------------- transforms --
void sp_encode_codes(const unsigned char* ascii, signed char* codes, long long n) {
    init_tables();
    for (long long i = 0; i < n; i++) codes[i] = (signed char)CODE_LUT[ascii[i]];
}

void sp_revcomp_ascii(const unsigned char* in, unsigned char* out,
                      long long rows, long long width) {
    init_tables();
    for (long long r = 0; r < rows; r++) {
        const unsigned char* src = in + r * width;
        unsigned char* dst = out + r * width;
        for (long long j = 0; j < width; j++)
            dst[j] = COMP_LUT[src[width - 1 - j]];
    }
}

// rows x w (w <= 32) ASCII -> uint64 2-bit keys; any non-ACGT poisons to ~0.
void sp_pack_2bit64(const unsigned char* ascii, unsigned long long* keys,
                    long long rows, long long w) {
    init_tables();
    for (long long r = 0; r < rows; r++) {
        const unsigned char* src = ascii + r * w;
        unsigned long long key = 0;
        bool bad = false;
        for (long long j = 0; j < w; j++) {
            unsigned char c = CODE_LUT[src[j]];
            if (c >= 4) { bad = true; break; }
            key |= ((unsigned long long)c) << (2 * j);
        }
        keys[r] = bad ? ~0ULL : key;
    }
}

// ------------------------------------------------------ exact counting ----
// Single-end counting hot loop. reads: rows x width ASCII matrix (0-padded);
// window [start, start+L+bc+R) sliced from each row; flank bytes compared;
// N anywhere in the row (within its length) skips it; the packed core is
// binary-searched in bc_keys_sorted (ascending). On a match,
// doc_counts[slot]++ ; otherwise, if flanks matched, the row index is
// appended to undoc_rows (caller decodes the cores). Returns number of
// undocumented rows recorded.
long long sp_count_exact(const unsigned char* reads, const long long* lengths,
                         long long rows, long long width,
                         long long start, const char* l_flank, long long l_len,
                         const char* r_flank, long long r_len, long long bc_len,
                         const unsigned long long* bc_keys_sorted, long long n_bc,
                         long long* doc_counts, long long* undoc_rows,
                         long long max_undoc) {
    init_tables();
    long long n_undoc = 0;
    long long W = l_len + bc_len + r_len;
    for (long long r = 0; r < rows; r++) {
        const unsigned char* row = reads + r * width;
        long long len = lengths[r] < width ? lengths[r] : width;
        bool has_n = false;
        for (long long j = 0; j < len; j++)
            if (row[j] == 'N') { has_n = true; break; }
        if (has_n) continue;
        if (start < 0 || start + W > width) continue;
        const unsigned char* win = row + start;
        bool flanks = true;
        for (long long j = 0; j < l_len && flanks; j++)
            if (win[j] != (unsigned char)l_flank[j]) flanks = false;
        for (long long j = 0; j < r_len && flanks; j++)
            if (win[l_len + bc_len + j] != (unsigned char)r_flank[j]) flanks = false;
        if (!flanks) continue;
        // pack core
        unsigned long long key = 0; bool bad = false;
        for (long long j = 0; j < bc_len; j++) {
            unsigned char c = CODE_LUT[win[l_len + j]];
            if (c >= 4) { bad = true; break; }
            key |= ((unsigned long long)c) << (2 * j);
        }
        if (!bad && n_bc > 0) {
            long long lo = 0, hi = n_bc - 1, found = -1;
            while (lo <= hi) {
                long long mid = (lo + hi) / 2;
                if (bc_keys_sorted[mid] == key) { found = mid; break; }
                if (bc_keys_sorted[mid] < key) lo = mid + 1; else hi = mid - 1;
            }
            if (found >= 0) { doc_counts[found]++; continue; }
        }
        if (n_undoc < max_undoc) undoc_rows[n_undoc++] = r;
    }
    return n_undoc;
}

// Multithreaded wrapper over the same per-row logic: rows are split into
// contiguous ranges, each thread tallies into private doc/undoc buffers,
// and results merge deterministically (doc by summation; undoc rows
// concatenated in thread order, so indices stay grouped-ascending). The
// reference parallelizes this loop with a fork pool of cpu_count()//2
// Python workers (heuristicount.py:720-722).
long long sp_count_exact_mt(const unsigned char* reads, const long long* lengths,
                            long long rows, long long width,
                            long long start, const char* l_flank, long long l_len,
                            const char* r_flank, long long r_len, long long bc_len,
                            const unsigned long long* bc_keys_sorted, long long n_bc,
                            long long* doc_counts, long long* undoc_rows,
                            long long max_undoc, long long n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > rows) n_threads = rows > 0 ? rows : 1;
    if (n_threads == 1)
        return sp_count_exact(reads, lengths, rows, width, start, l_flank, l_len,
                              r_flank, r_len, bc_len, bc_keys_sorted, n_bc,
                              doc_counts, undoc_rows, max_undoc);
    // LUT init BEFORE spawning: the plain tables_ready flag is not a
    // synchronization point, so racing workers could observe it set
    // before the table stores are visible and miscode bases
    init_tables();
    std::vector<std::vector<long long>> docs((size_t)n_threads,
                                             std::vector<long long>((size_t)n_bc, 0));
    std::vector<std::vector<long long>> undocs((size_t)n_threads);
    std::vector<std::thread> workers;
    long long per = (rows + n_threads - 1) / n_threads;
    for (long long t = 0; t < n_threads; t++) {
        long long r0 = t * per;
        long long r1 = r0 + per < rows ? r0 + per : rows;
        if (r0 >= r1) break;
        workers.emplace_back([=, &docs, &undocs]() {
            std::vector<long long>& undoc = undocs[(size_t)t];
            // a range yields at most one undoc row per read — sizing to
            // max_undoc zeroed n_threads x 8 MB per chunk call
            long long cap = max_undoc < (r1 - r0) ? max_undoc : (r1 - r0);
            undoc.resize((size_t)cap);
            long long n = sp_count_exact(reads + r0 * width, lengths + r0,
                                         r1 - r0, width, start, l_flank, l_len,
                                         r_flank, r_len, bc_len, bc_keys_sorted,
                                         n_bc, docs[(size_t)t].data(),
                                         undoc.data(), cap);
            undoc.resize((size_t)n);
            for (long long& v : undoc) v += r0;  // back to global row indices
        });
    }
    for (auto& w : workers) w.join();
    for (long long t = 0; t < (long long)docs.size(); t++)
        for (long long b = 0; b < n_bc; b++) doc_counts[b] += docs[(size_t)t][b];
    long long n_undoc = 0;
    for (auto& u : undocs)
        for (long long v : u)
            if (n_undoc < max_undoc) undoc_rows[n_undoc++] = v;
    return n_undoc;
}

}  // extern "C"
