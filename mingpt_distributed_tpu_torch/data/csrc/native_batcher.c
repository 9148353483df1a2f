/* native_batcher: the char dataset's batch gather in C.
 *
 * The port's own copy of the loop in the repository's
 * runtime/native_batcher.c, behind a plain C interface (no Python.h) that
 * data/native_batcher.py binds with ctypes. ctypes releases the GIL for the
 * call, so a prefetch thread (data/prefetch.py) assembles the next batch
 * while the main thread runs the step.
 *
 *   gather_windows(data, corpus_len, starts, n, block_size, out)
 *     data:   corpus_len int32 token ids
 *     starts: n int64 window start offsets
 *     out:    n * (block_size + 1) int32, row i = data[starts[i] ...]
 *   returns 0, or i + 1 for the first start i whose window leaves the
 *   corpus (nothing is written then).
 */

#include <stdint.h>
#include <string.h>

int64_t gather_windows(const int32_t* data, int64_t corpus_len,
                       const int64_t* starts, int64_t n, int64_t block_size,
                       int32_t* out) {
  const int64_t window = block_size + 1;
  for (int64_t i = 0; i < n; ++i) {
    if (starts[i] < 0 || starts[i] + window > corpus_len) {
      return i + 1;
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    memcpy(out + i * window, data + starts[i], (size_t)window * sizeof(int32_t));
  }
  return 0;
}
