// Native single-pass kernels for the port's host-side ragged data plane
// (the port's own copy of ebnerd_tpu/native/ragged_kernels.cc, with the
// same entry points).
//
// The numpy kernels in data/ragged.py and data/lookup.py are vectorized
// but multi-pass (the _ranges prefix-sum trick materializes index arrays);
// these C++ kernels do the same work in one cache-friendly pass. Bound via
// ctypes (ebnerd_tpu_torch/native/__init__.py); outputs are bit-identical
// to the numpy path, which runs only for the types these kernels do not
// take or when EBNERD_TPU_NO_NATIVE=1.
//
// ABI: plain C functions over raw pointers; int64 offsets (Arrow layout),
// int32/int64 values. No Python.h — keeps the build a single g++ -shared.

#include <cstdint>
#include <cstring>

extern "C" {

// out[k] = values[starts[i] + j] for row i, j < lengths[i], concatenated.
// The fused form of data/ragged.py::_ranges + values[idx]
// (backbone of Ragged.take_rows / Ragged.tail).
void gather_ranges_i32(const int32_t* values, const int64_t* starts,
                       const int64_t* lengths, int64_t n_rows,
                       int32_t* out) {
  int64_t k = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    const int32_t* src = values + starts[i];
    const int64_t len = lengths[i];
    std::memcpy(out + k, src, static_cast<size_t>(len) * sizeof(int32_t));
    k += len;
  }
}

void gather_ranges_i64(const int64_t* values, const int64_t* starts,
                       const int64_t* lengths, int64_t n_rows,
                       int64_t* out) {
  int64_t k = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    std::memcpy(out + k, values + starts[i],
                static_cast<size_t>(lengths[i]) * sizeof(int64_t));
    k += lengths[i];
  }
}

void gather_ranges_f32(const float* values, const int64_t* starts,
                       const int64_t* lengths, int64_t n_rows, float* out) {
  int64_t k = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    std::memcpy(out + k, values + starts[i],
                static_cast<size_t>(lengths[i]) * sizeof(float));
    k += lengths[i];
  }
}

// offsets+values -> dense [n, width] + bool mask, one pass.
// align_right != 0: end-aligned (left-padded) keeping each row's tail —
// the reference's history layout (truncate_history, _behaviors.py:582-654);
// align_right == 0: start-aligned keeping the head (candidate lists).
// `out` must be pre-filled with the pad value by the caller.
void to_padded_i32(const int32_t* values, const int64_t* offsets,
                   int64_t n_rows, int64_t width, int align_right,
                   int32_t* out, uint8_t* mask) {
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t len = offsets[i + 1] - offsets[i];
    if (len > width) len = width;
    const int64_t src = align_right ? offsets[i + 1] - len : offsets[i];
    const int64_t dst = i * width + (align_right ? width - len : 0);
    std::memcpy(out + dst, values + src,
                static_cast<size_t>(len) * sizeof(int32_t));
    std::memset(mask + dst, 1, static_cast<size_t>(len));
  }
}

// Vectorized id -> row-index over a sorted unique id table; unknown -> 0,
// known ids[i] -> i + 1 (data/lookup.py::Lookup.map_ids semantics,
// the reference's create_lookup_objects).
void map_ids_i64(const int64_t* sorted_ids, int64_t n_ids,
                 const int64_t* query, int64_t n_query, int32_t* out) {
  for (int64_t q = 0; q < n_query; ++q) {
    const int64_t key = query[q];
    int64_t lo = 0, hi = n_ids;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (sorted_ids[mid] < key) lo = mid + 1; else hi = mid;
    }
    out[q] = (lo < n_ids && sorted_ids[lo] == key)
                 ? static_cast<int32_t>(lo + 1) : 0;
  }
}

// Per-row membership: for each value in row i of `a`, is it in row i of
// `b`? Rows here are tiny (inview ~5-30, clicked ~1-2), so a direct scan
// beats hashing (kernel behind create_binary_labels_column,
// reference: _behaviors.py:22-107).
void isin_per_row_i64(const int64_t* a_vals, const int64_t* a_off,
                      const int64_t* b_vals, const int64_t* b_off,
                      int64_t n_rows, uint8_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t* b = b_vals + b_off[i];
    const int64_t nb = b_off[i + 1] - b_off[i];
    for (int64_t j = a_off[i]; j < a_off[i + 1]; ++j) {
      const int64_t v = a_vals[j];
      uint8_t hit = 0;
      for (int64_t k = 0; k < nb; ++k) {
        if (b[k] == v) { hit = 1; break; }
      }
      out[j] = hit;
    }
  }
}

}  // extern "C"
