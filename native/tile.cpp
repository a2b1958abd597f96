// Native proof-ingestion relayout for the tiled fast path.
//
// models/stwo/tiled.py turns each per-query proof array from the proof
// container's (B, Q, ..., W)-trailing layout into the stage kernels'
// word-major (..., W, M, 128) layout (lanes contiguous).  The core of that
// relayout is a plain (rows x cols) -> (cols x rows_padded) u32 transpose,
// which numpy does single-threaded through a strided copy.  Ingestion runs
// on the host, like the reference's witness generator
// (stwo-verifier/scripts/generate_wit.py), and deserves native code.
//
// Blocked, thread-parallel transpose: 64x64 u32 blocks (16 KiB in, fits
// L1) over POSIX threads (gcc's libgomp is avoided so the .so has no
// runtime deps beyond libpthread).
//
// Build: make -C native libstile.so (tiled.py runs it at first use and
// uses numpy when the build fails).

#include <cstdint>
#include <cstring>
#include <pthread.h>

#include <algorithm>
#include <vector>

namespace {

constexpr size_t kBlock = 64;

struct Job {
    const uint32_t* in;   // (rows, cols), C-contiguous
    uint32_t* out;        // (cols, out_rows) with out_rows >= rows
    size_t rows, cols, out_rows;
    size_t row_begin, row_end;  // this worker's slice of the row axis
};

void* transpose_worker(void* arg) {
    const Job& j = *static_cast<const Job*>(arg);
    for (size_t rb = j.row_begin; rb < j.row_end; rb += kBlock) {
        const size_t rmax = std::min(rb + kBlock, j.row_end);
        for (size_t cb = 0; cb < j.cols; cb += kBlock) {
            const size_t cmax = std::min(cb + kBlock, j.cols);
            for (size_t r = rb; r < rmax; ++r) {
                const uint32_t* src = j.in + r * j.cols;
                for (size_t c = cb; c < cmax; ++c) {
                    j.out[c * j.out_rows + r] = src[c];
                }
            }
        }
    }
    return nullptr;
}

}  // namespace

extern "C" {

// out (cols, out_rows) = in (rows, cols) transposed; rows..out_rows-1 of
// every output row are zero-filled (lane padding).  n_threads <= 0 picks
// a small default.
void stile_transpose_pad_u32(const uint32_t* in, uint32_t* out,
                             size_t rows, size_t cols, size_t out_rows,
                             int n_threads) {
    if (out_rows < rows) return;  // no room for the input: write nothing
    if (out_rows > rows) {
        // zero the pad region first (tail of each output row)
        for (size_t c = 0; c < cols; ++c) {
            std::memset(out + c * out_rows + rows, 0,
                        (out_rows - rows) * sizeof(uint32_t));
        }
    }
    size_t nt = n_threads > 0 ? static_cast<size_t>(n_threads) : 2;
    nt = std::max<size_t>(1, std::min(nt, (rows + kBlock - 1) / kBlock));

    std::vector<Job> jobs(nt);
    std::vector<pthread_t> tids(nt);
    // split the row axis into block-aligned slices
    const size_t blocks = (rows + kBlock - 1) / kBlock;
    const size_t per = (blocks + nt - 1) / nt;
    for (size_t t = 0; t < nt; ++t) {
        const size_t b0 = std::min(t * per, blocks);
        const size_t b1 = std::min(b0 + per, blocks);
        jobs[t] = Job{in, out, rows, cols, out_rows,
                      b0 * kBlock, std::min(b1 * kBlock, rows)};
    }
    for (size_t t = 1; t < nt; ++t) {
        pthread_create(&tids[t], nullptr, transpose_worker, &jobs[t]);
    }
    transpose_worker(&jobs[0]);
    for (size_t t = 1; t < nt; ++t) {
        pthread_join(tids[t], nullptr);
    }
}

}  // extern "C"
